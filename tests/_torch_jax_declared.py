"""The JAX package's bfloat16 and float32 serving runs with XLA's excess
precision off, in a process of their own:

    python tests/_torch_jax_declared.py IN_NPZ OUT_NPZ

XLA's CPU compiler may keep bfloat16 intermediates of a fused computation
in float32 (``--xla_allow_excess_precision``, on by default): a license
of the compiler, not the program's semantics.  With the flag off, the
compiled program rounds where its own dtypes say it does, as the port's
eager ops do.  The flag is read once, when XLA's CPU backend starts, and
a test process has usually started it already; so :func:`declared_serve`
runs ``test_torch_mesh_serve._jax_serve`` in a child process whose
``XLA_FLAGS`` end with the flag, and passes the arrays through ``.npz``
files.

IN_NPZ holds the arch, the seed of the bfloat16 draw
(``PRNGKey(seed)``, upcast for the float32 run, as the test draws), the
decode tokens, the prefill length and the prompt (``b:``); OUT_NPZ holds
the prefill's and each decode step's logits of both runs (``prefill16``,
``logits16``, ``prefill``, ``logits``), in float32.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

FLAG = "--xla_allow_excess_precision=false"
TESTS = Path(__file__).resolve().parent


def declared_serve(tmp: Path, arch: str, prompt: dict, toks: np.ndarray, total: int,
                   seed: int = 0, timeout: float = 300) -> dict:
    """The JAX package's bfloat16 and float32 runs of ``arch``'s reduced
    config, drawn from ``seed``, compiled without excess precision: the
    child's outputs by name.  A child that fails or outlives ``timeout``
    fails the caller, with its output."""
    tmp.mkdir(parents=True, exist_ok=True)
    src, out = tmp / "declared_in.npz", tmp / "declared_out.npz"
    np.savez(src, arch=np.array(arch), seed=np.array(seed), total=np.array(total),
             decode=toks, **{f"b:{k}": v for k, v in prompt.items()})
    # FLAG appended to XLA_FLAGS, JAX on the CPU, the repo's src on the path
    path = os.pathsep.join(p for p in (str(TESTS.parent / "src"), os.environ.get("PYTHONPATH"))
                           if p)
    env = {**os.environ, "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {FLAG}".strip(),
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": path}
    run = subprocess.run([sys.executable, __file__, str(src), str(out)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=timeout)
    if run.returncode != 0:
        raise AssertionError(f"the declared-rounding JAX run exited with {run.returncode}:\n"
                             f"{run.stdout[-3000:]}")
    return dict(np.load(out))


def main(argv) -> int:
    src, out = argv
    assert FLAG in os.environ.get("XLA_FLAGS", "").split(), "run through declared_serve"
    import jax
    import jax.numpy as jnp
    import test_torch_mesh_serve as T
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro.models.params import initialize as jax_initialize

    data = np.load(src)
    arch, seed, total = str(data["arch"]), int(data["seed"]), int(data["total"])
    prompt = {k[2:]: data[k] for k in data.files if k.startswith("b:")}
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        jmodel = jax_build(dataclasses.replace(jax_config(arch).reduced(), dtype="bfloat16"))
        jhalf = jax_initialize(jmodel.specs(), jax.random.PRNGKey(seed))
        _, prefill16, logits16, _, _ = T._jax_serve(arch, prompt, data["decode"], total,
                                                    "bfloat16", jhalf)
        jfull = jax.tree.map(lambda a: a.astype(jnp.float32), jhalf)
        _, prefill, logits, _, _ = T._jax_serve(arch, prompt, data["decode"], total, "float32",
                                                jfull)
    np.savez(out, prefill16=prefill16, logits16=logits16, prefill=prefill, logits=logits)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
