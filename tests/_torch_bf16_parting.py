"""Where the port's bfloat16 serving run and the JAX package's part, on the
CPU, at the reduced phi3.5-moe-42b-a6.6b config:

    PYTHONPATH=src python tests/_torch_bf16_parting.py [--seed 11]

It runs itself again in a child process whose ``XLA_FLAGS`` end with
``--xla_allow_excess_precision=false`` (``tests/_torch_jax_declared.py``),
so the JAX package rounds where its program says.  It prints:

1. the activations on 200,000 bfloat16 values: ``F.silu`` and ``F.gelu``
   (which round once) and the port's ``layers.silu`` and
   ``layers.gelu_tanh`` (the JAX package's lowering, every op rounded),
   each against ``jax.nn.silu`` and ``jax.nn.gelu``: values that differ;
2. for the draw of ``--seed`` (weights ``PRNGKey(seed)``, prompt and
   tokens ``default_rng(seed)``; seed 0 is the test's draw, prompt seed 3
   and tokens seed 5): whether the JAX package's compiled run equals its
   run op by op, bit for bit; then every ``apply_norm``, ``attn_decode``
   and ``moe_apply`` call of both, the prefill (``build_prefill_step``)
   and each decode step, and the first call whose input is equal and whose
   output is not, with the values that differ;
3. if that call is ``moe_apply``: which of its intermediates differ on the
   same input and weights (the router's logits, the top-k gates in
   bfloat16, the experts' products, the activation, the down product on
   equal operands);
4. the port's and the JAX package's bfloat16 distance from their float32
   runs at the prefill and each step (``test_torch_mesh_serve._step_rel``).

"""

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _torch_jax_declared import FLAG  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"


def f32(a) -> np.ndarray:
    import torch
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.array(a.astype("float32")))


def differ(a, b) -> str:
    a, b = f32(a), f32(b)
    return (f"{int((a != b).sum())} of {a.size} differ, "
            f"{float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)):.3e} of the largest")


def activations():
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    x = jnp.asarray(np.random.default_rng(0).standard_normal(200_000) * 4, jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    for name, once, port in (("silu", F.silu, L.silu),
                             ("gelu", lambda t: F.gelu(t, approximate="tanh"), L.gelu_tanh)):
        want = jax.jit(getattr(jax.nn, name))(x)
        print(f"1. {name} on {x.size:,} bfloat16 values against jax.nn.{name}: F.{name} "
              f"{differ(once(xt), want)}; the port's {differ(port(xt), want)}")


def record(modules, calls: list):
    """Wrap apply_norm, attn_decode and moe_apply of (layers, moe) modules
    by attribute; each concrete call appends (name, params, input, output)."""
    import jax

    def wrap(mod, name):
        orig = getattr(mod, name)

        def fn(*a, **k):
            out = orig(*a, **k)
            y = out[0] if isinstance(out, tuple) else out
            if not isinstance(y, jax.core.Tracer):
                calls.append((name, a[0], a[1], y))
            return out
        setattr(mod, name, fn)
    layers, moe = modules
    for name in ("apply_norm", "attn_decode"):
        wrap(layers, name)
    wrap(moe, "moe_apply")


def moe_parts(jp, tp, x16, cfg, jcfg) -> dict:
    """The MoE's intermediates on the same bfloat16 input and weights:
    {name: (JAX package's, port's)}; the JAX side is its ``_moe_dispatch``
    step by step, op by op, the experts' products on the JAX package's
    expert buffer and the down product on its ``h`` for both."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.models import moe as MOE

    b, s, d = x16.shape
    e, k = jcfg.num_experts, jcfg.experts_per_token
    t = b * s
    out = {}
    with jax.disable_jit():
        x = jnp.asarray(f32(x16), jnp.bfloat16)
        xf = x.reshape(t, d)
        logits = xf.astype(jnp.float32) @ jp["router"]
        topk_g, topk_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        topk_g = topk_g / jnp.maximum(topk_g.sum(-1, keepdims=True), 1e-9)
        cap = max(int(np.ceil(t * k / e * jcfg.moe_capacity_factor)), 4)
        flat = jax.nn.one_hot(topk_i, e, dtype=jnp.int32).reshape(t * k, e)
        pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(t, k)
        disp = (jax.nn.one_hot(topk_i, e, dtype=x.dtype)[..., None]
                * jax.nn.one_hot(pos, cap, dtype=x.dtype)[:, :, None, :]
                * (pos < cap)[..., None, None].astype(x.dtype))
        expert_in = jnp.einsum("td,tec->ecd", xf, disp.sum(1))
        g = jnp.einsum("ecd,edf->ecf", expert_in, jp["wg"])
        u = jnp.einsum("ecd,edf->ecf", expert_in, jp["wu"])
        act = jax.nn.silu(g)
        h = act * u
        down = jnp.einsum("ecf,efd->ecd", h, jp["wd"])
    xt = x16.reshape(t, d)
    _, tg, ti = MOE.route(tp, xt, cfg)
    ein = torch.from_numpy(f32(expert_in)).to(torch.bfloat16)
    gt = torch.bmm(ein, tp["wg"])
    out["router logits (float32)"] = (logits, xt.float() @ tp["router"])
    out["top-k experts"] = (topk_i.astype(jnp.float32), ti.float())
    out["top-k gates in bfloat16"] = (topk_g.astype(jnp.bfloat16), tg.to(torch.bfloat16))
    out["gate product"] = (g, gt)
    out["up product"] = (u, torch.bmm(ein, tp["wu"]))
    out["activation, on the JAX package's gate product"] = (
        act, MOE.silu(torch.from_numpy(f32(g)).to(torch.bfloat16)))
    out["down product, on the JAX package's h"] = (
        down, torch.bmm(torch.from_numpy(f32(h)).to(torch.bfloat16), tp["wd"]))
    return out


def run(seed: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_mesh_serve as T
    from _torch_jax_declared import declared_serve
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro.models import layers as JL
    from repro.models import moe as JM
    from repro.models.params import initialize as jax_initialize
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import build_model
    from repro_torch.models import layers as PL
    from repro_torch.models import moe as PM

    activations()
    pseed, tseed = (3, 5) if seed == 0 else (seed, seed)
    cfg = get_config(ARCH).reduced()
    half = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="bfloat16")
    prompt = {"tokens": np.random.default_rng(pseed).integers(
        0, cfg.vocab_size, (T.B, T.S)).astype(np.int32)}
    toks = np.random.default_rng(tseed).integers(0, cfg.vocab_size, (T.B, T.STEPS)).astype(np.int32)
    jhalf = jax_initialize(jax_build(jcfg).specs(), jax.random.PRNGKey(seed))
    jcalls, pcalls = [], []
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        record((JL, JM), jcalls)
        _, cp, cl, _, _ = T._jax_serve(ARCH, prompt, toks, T.S, "bfloat16", jhalf)
        jcalls.clear()
        with jax.disable_jit():
            _, ep, el, _, _ = T._jax_serve(ARCH, prompt, toks, T.S, "bfloat16", jhalf)
    print(f"2. seed {seed}: the JAX package "
          f"compiled equals its run op by op: prefill {np.array_equal(cp, ep)}, steps "
          f"{[bool(np.array_equal(a, b)) for a, b in zip(cl, el)]}")
    jfull = jax.tree.map(lambda a: a.astype(jnp.float32), jhalf)
    model = lm_params_from_jax(jax.tree.map(np.asarray, jfull), build_model(cfg, device="cpu"))
    model16 = build_model(half, device="cpu")
    with torch.no_grad():
        for w, p in zip(model16.parameters(), model.parameters()):
            w.copy_(p)
    record((PL, PM), pcalls)
    prefill16, logits16, _ = T._port_serve(model16, half, prompt, toks, T.S)
    # calls: a prefill's, two norms and the MoE a layer and the final norm; a step's, the
    # attention too.  The JAX package's: build_prefill_step, prefill (for the caches),
    # then each step's greedy decode and its decode_step; the port's: the prefill, the steps
    n_pre, per_step = 3 * cfg.num_layers + 1, 4 * cfg.num_layers + 1
    assert len(pcalls) == n_pre + T.STEPS * per_step, len(pcalls)
    assert len(jcalls) == 2 * n_pre + 2 * T.STEPS * per_step, len(jcalls)
    phases = [("prefill", jcalls[:n_pre], pcalls[:n_pre])] + [
        (f"step {t}", jcalls[2 * n_pre + (2 * t + 1) * per_step:2 * n_pre + (2 * t + 2) * per_step],
         pcalls[n_pre + t * per_step:n_pre + (t + 1) * per_step]) for t in range(T.STEPS)]
    first = None
    for phase, js, ps in phases:
        for i, (j, p) in enumerate(zip(js, ps)):
            assert j[0] == p[0], (phase, i, j[0], p[0])
            if first is None and np.array_equal(f32(j[2]), f32(p[2])) \
                    and not np.array_equal(f32(j[3]), f32(p[3])):
                first = (phase, i, j, p)
    if first is None:
        print("   no call parts on equal inputs")
    else:
        phase, i, j, p = first
        print(f"   first to part on an equal input: {phase}, call {i} ({j[0]}), output "
              f"{differ(p[3], j[3])}")
        if j[0] == "moe_apply":
            for name, (a, b) in moe_parts(j[1], p[1], p[2], half, jcfg).items():
                print(f"3. {name}: {differ(b, a)}")
    with tempfile.TemporaryDirectory() as tmp:
        jd = declared_serve(Path(tmp), ARCH, prompt, toks, T.S, seed=seed)
    prefill, logits, _ = T._port_serve(model, cfg, prompt, toks, T.S)
    port = T._step_rel(prefill16, logits16, prefill, logits)
    decl = T._step_rel(jd["prefill16"], jd["logits16"], jd["prefill"], jd["logits"])
    print(f"4. bfloat16 from float32, prefill then each step: port {np.round(port, 4).tolist()}; "
          f"the JAX package without excess precision {np.round(decl, 4).tolist()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    if FLAG not in os.environ.get("XLA_FLAGS", "").split():
        env = {**os.environ, "XLA_FLAGS": f"{os.environ.get('XLA_FLAGS', '')} {FLAG}".strip(),
               "JAX_PLATFORMS": "cpu"}
        return subprocess.run([sys.executable, __file__] + sys.argv[1:], env=env).returncode
    run(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
