"""``tests/test_torch_mesh_serve.py``'s bfloat16 comparison over other
seeds, outside the test: the test's own draw first, then for each seed
the JAX package's reduced model drawn from ``PRNGKey(seed)`` in bfloat16
and upcast for float32, a prompt and decode tokens from
``default_rng(seed)``; the unsharded port and the
JAX package each serve it in both dtypes, and each one's bfloat16 run is
held to its own float32 run at the prefill and at every decode step (the
largest logit error over the float32 run's largest logit, as the test's
``_step_rel``); the JAX package's bfloat16 run also op by op
(``jax.disable_jit``), where XLA fuses no ops and each rounds its result
to bfloat16, as the port's eager ops do, and compiled without excess
precision (``jax_declared``: both of its runs in a child process with
``--xla_allow_excess_precision=false``, ``tests/_torch_jax_declared.py``),
which the test holds the port to.  Shows whether the port's bfloat16 run
strays where the JAX package's does not, or both do on the same seeds.
With ``--mesh`` each draw is also served on the test's 2 × 2 mesh of 4
gloo processes (``tests/_torch_ranks.py serve``): rank 0's bfloat16
distance from the unsharded bfloat16 run at each point, whether its first
step's greedy tokens are the unsharded run's, and the unsharded first
step's gap between its two largest logits, by row.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_bf16_seeds.py \\
        phi3.5-moe-42b-a6.6b --seeds 0 1 2 3
"""

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_mesh_serve as T  # noqa: E402
from _torch_jax_declared import declared_serve  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.params import initialize as jax_initialize  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def mesh(arch: str, model, prompt, toks, prefill16, logits16, prefill, logits) -> dict:
    """Rank 0 of the 2 × 2 mesh in bfloat16 against the unsharded bfloat16 run."""
    from _torch_ranks import run_ranks

    inputs = {"arch": np.array(arch), "dtype": np.array("bfloat16"), "decode": toks,
              **{f"b:{k}": v for k, v in prompt.items()},
              **{f"p:{n}": p.detach().numpy() for n, p in model.named_parameters()}}
    with tempfile.TemporaryDirectory() as tmp:
        r0 = run_ranks(Path(tmp), "serve", inputs, 4, timeout=T.TIMEOUT)[0]
    scale = max(float(np.abs(prefill).max()), float(np.abs(logits).max()))   # float32's
    apart = [r0["prefill"] - prefill16] + [a - b for a, b in zip(r0["logits"], logits16)]
    top2 = np.sort(logits16[0], axis=-1)[:, -2:]
    return {"mesh_from_unsharded": [float(np.abs(d).max()) / scale for d in apart],
            "mesh_first_tokens_equal": bool((r0["next"][:, 0]
                                             == np.argmax(logits16[0], -1)).all()),
            "unsharded_top2_gap": (top2[:, 1] - top2[:, 0]).tolist()}


def one_seed(arch: str, seed: int, prompt_seed: int, toks_seed: int,
             with_mesh: bool = False) -> dict:
    cfg = get_config(arch).reduced()
    half = dataclasses.replace(cfg, dtype="bfloat16")
    prompt = {"tokens": np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab_size, (T.B, T.S)).astype(np.int32)}
    toks = np.random.default_rng(toks_seed).integers(
        0, cfg.vocab_size, (T.B, T.STEPS)).astype(np.int32)
    total = T.S
    jmodel = jax_build(dataclasses.replace(jax_config(arch).reduced(), dtype="bfloat16"))
    jhalf = jax_initialize(jmodel.specs(), jax.random.PRNGKey(seed))
    _, jprefill16, jlogits16, _, _ = T._jax_serve(arch, prompt, toks, total, "bfloat16", jhalf)
    jfull = jax.tree.map(lambda a: a.astype(jnp.float32), jhalf)
    _, jprefill, jlogits, _, _ = T._jax_serve(arch, prompt, toks, total, "float32", jfull)
    with jax.disable_jit():      # op by op, each op rounding to bfloat16 as the port's do
        _, eprefill16, elogits16, _, _ = T._jax_serve(arch, prompt, toks, total, "bfloat16",
                                                      jhalf)
    with tempfile.TemporaryDirectory() as tmp:
        jd = declared_serve(Path(tmp), arch, prompt, toks, total, seed=seed)
    model = lm_params_from_jax(jax.tree.map(np.asarray, jfull), build_model(cfg, device="cpu"))
    model16 = build_model(half, device="cpu")
    with T.torch.no_grad():
        for w, p in zip(model16.parameters(), model.parameters()):
            w.copy_(p)
    prefill, logits, _ = T._port_serve(model, cfg, prompt, toks, total)
    prefill16, logits16, _ = T._port_serve(model16, half, prompt, toks, total)
    runs = {"port": (prefill16, logits16, prefill, logits),
            "jax": (jprefill16, jlogits16, jprefill, jlogits),
            "jax_eager": (eprefill16, elogits16, jprefill, jlogits),
            "jax_declared": (jd["prefill16"], jd["logits16"], jd["prefill"], jd["logits"])}
    row = {"seeds": [seed, prompt_seed, toks_seed],
           **{k: T._step_rel(*v).tolist() for k, v in runs.items()}}
    if with_mesh:
        row.update(mesh(arch, model, prompt, toks, prefill16, logits16, prefill, logits))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--mesh", action="store_true", help="also serve each draw on the mesh")
    args = ap.parse_args()
    rows = []
    # the test's own draw first (weights from key 0, prompt seed 3, tokens 5)
    for seed, prompt_seed, toks_seed in [(0, 3, 5)] + [(s, s, s) for s in args.seeds]:
        row = one_seed(args.arch, seed, prompt_seed, toks_seed, args.mesh)
        rows.append(row)
        print(f"seeds {seed}, {prompt_seed}, {toks_seed}: bfloat16 from float32, prefill then "
              "each step; port " + " ".join(f"{e:.4f}" for e in row["port"]) + "; JAX package "
              + " ".join(f"{e:.4f}" for e in row["jax"]) + "; JAX package op by op "
              + " ".join(f"{e:.4f}" for e in row["jax_eager"])
              + "; JAX package without excess precision "
              + " ".join(f"{e:.4f}" for e in row["jax_declared"])
              + f"; worst {max(row['port']):.4f} against {max(row['jax']):.4f}, "
              f"{max(row['jax_eager']):.4f} and {max(row['jax_declared']):.4f}", flush=True)
        if args.mesh:
            print("    mesh rank 0 from the unsharded bfloat16 run "
                  + " ".join(f"{e:.4f}" for e in row["mesh_from_unsharded"])
                  + f"; first tokens equal {row['mesh_first_tokens_equal']}; the unsharded first "
                  "step's top-two gaps " + " ".join(f"{g:.5f}" for g in row["unsharded_top2_gap"]),
                  flush=True)
    print(json.dumps({"arch": args.arch, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
