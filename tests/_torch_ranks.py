"""One rank of the port's multi-process tests, run as a script:

    python tests/_torch_ranks.py MODE RANK WORLD INIT_FILE IN_NPZ OUT_DIR DEVICE

:func:`run_ranks` (``tests/test_torch_mesh.py``, ``tests/test_torch_mesh_train.py``)
starts WORLD of these, each in a process of its own with a time limit, and
reads ``OUT_DIR/rank<RANK>.npz``.  The
process group is gloo, rendezvous through ``file://INIT_FILE`` (no port);
DEVICE is ``cpu``, or ``cuda`` for ranks that share one card.  It imports
torch, the port and (MODEs ``train`` and ``serve``) ``chip_smoke.py`` only.

MODE ``coded``: the worker-mesh ``CodedMatvec`` on ``make_worker_mesh``;
IN_NPZ holds A, x, the code's (n, k), C and the speed vectors; the output
holds y under each speed vector and this rank's kernel launches.

``python tests/_torch_ranks.py layout ARCH MULTI_POD RANKS OUT_JSON``
runs no collective: it makes a ``fake`` group of 256 (512 with MULTI_POD
1) ranks at each of the RANKS (a JSON list) in turn and writes the local
shapes and offsets of the arch's train state (:func:`layout`).

MODE ``train``: one sharded ``build_train_step`` on a ``("data",
"model")`` mesh (``chip_smoke.py``'s ``mesh_train_run``, as phase 11
(e)'s ranks train), 2 × 2 unless IN_NPZ holds ``mesh``; IN_NPZ holds the
arch, the port's parameters by name, the batch and the learning rate; the
output holds the loss, the gradient norm and every parameter after the
step, gathered.  With ``prefill`` in IN_NPZ, ``build_prefill_step`` runs
first, on a sharded copy of the parameters of its own, on the batch's
tokens (and image embeds or frames), and the output also holds its last
position's logits, gathered.

MODE ``serve``: ``build_prefill_step`` (room for ``steps`` more tokens)
and then ``steps`` calls of ``build_decode_step`` (``chip_smoke.py``'s
``mesh_serve_run``, as phase 11 (d)'s ranks serve), on the mesh of IN_NPZ
(2 × 2 without one), the weights placed by ``shard_model`` with
``serve_rules``, as the dry-run places a serving cell's; IN_NPZ holds the
arch, the parameters, the prompt (``b:``), the tokens each step decodes
(``decode``) and, optionally, the model's ``dtype``.  The output holds
the prefill's logits and greedy token (``first``), each step's logits
(what ``decode_step`` returned to ``build_decode_step``'s step) and next
tokens, every cache after the last step, all
gathered, and ``placed``: whether every cache was a DTensor placed by
``cache_sharding_rules`` after the prefill and after each step.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def coded(rank: int, world: int, data, dev: torch.device) -> dict:
    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_mesh

    n, k = (int(v) for v in data["nk"])
    chunks = int(data["chunks"])
    mesh = make_worker_mesh(world, device_type=dev.type)
    cm = CodedMatvec(MDSCode(n, k), chunks, device=dev, mesh=mesh)
    ops.reset_launch_counts()
    part = cm.shard(torch.from_numpy(data["a"]))        # A stays on the host
    x = torch.from_numpy(data["x"]).to(dev)
    out = {"rows": np.array(part.shape[0])}
    for i, speeds in enumerate(data["speeds"]):
        tables = cm.plan_tables(general_allocation(speeds, k, chunks))
        out[f"y{i}"] = cm.apply(part, x, *tables).cpu().numpy()
    out["launches"] = np.array([ops.launch_counts()[name] for name in
                                ("coded_matvec", "mds_encode", "mds_decode")])
    return out


def train(rank: int, world: int, data, dev: torch.device) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import mesh_train_run
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.partition import local
    from repro_torch.launch.steps import build_prefill_step, shard_model
    from repro_torch.models import build_model

    cfg = get_config(str(data["arch"])).reduced()
    shape_ = tuple(int(v) for v in data["mesh"]) if "mesh" in data.files else (2, 2)
    mesh = init_device_mesh(dev.type, shape_, mesh_dim_names=("data", "model"))

    def drawn():
        model = build_model(cfg, device=dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(data["p:" + name]))
        return model

    batch = {k[2:]: torch.from_numpy(data[k]).to(dev) for k in data.files if k.startswith("b:")}
    out = {}
    if "prefill" in data.files:         # the sharded prefill, on a copy of its own
        model = shard_model(drawn(), mesh)
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        with mesh:
            logits, _ = build_prefill_step(cfg)(model, SH.place(inputs,
                                                                SH.batch_shardings(mesh, inputs)))
        out["logits"] = local(logits).detach().float().cpu().numpy()
        del model, logits

    def keep(name, whole):
        out["p:" + name] = whole.float().cpu().numpy()

    run = mesh_train_run(drawn(), cfg, mesh, batch, float(data["lr"]), each_param=keep)
    out.update(loss=np.array(run["loss"]), grad_norm=np.array(run["grad_norm"]))
    return out


def serve(rank: int, world: int, data, dev: torch.device) -> dict:
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import caches_placed, mesh_serve_run
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import serve_rules, shard_model
    from repro_torch.models import build_model

    cfg = get_config(str(data["arch"])).reduced()
    if "dtype" in data.files:
        cfg = dataclasses.replace(cfg, dtype=str(data["dtype"]))
    shape_ = tuple(int(v) for v in data["mesh"]) if "mesh" in data.files else (2, 2)
    mesh = init_device_mesh(dev.type, shape_, mesh_dim_names=("data", "model"))
    model = build_model(cfg, device=dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(data["p:" + name]))
    shard_model(model, mesh, serve_rules(cfg, tp=shape_[1]) or None)
    batch = {k[2:]: torch.from_numpy(data[k]).to(dev) for k in data.files if k.startswith("b:")}
    with mesh:
        run = mesh_serve_run(model, cfg, SH.place(batch, SH.batch_shardings(mesh, batch)),
                             data["decode"].shape[1], torch.from_numpy(data["decode"]),
                             lambda caches: caches_placed(mesh, caches))
    out = {"placed": np.array(run["placed"]), "prefill": run["prefill"].numpy(),
           "logits": run["logits"].numpy(), "first": run["first"].numpy(),
           "next": run["greedy"].numpy()}
    for i, entry in enumerate(run["caches"]):
        for kind, state in entry.items():
            for name, c in state.items():
                out[f"c:{i}:{kind}:{name}"] = c.full_tensor().float().cpu().numpy()
    return out


def layout(arch: str, multi_pod: bool, ranks, out_json: str) -> None:
    """Each parameter's and optimizer-state leaf's local shape (from a
    DTensor on ``meta``) and global offset at the given ranks of a ``fake``
    group of 256 or 512 ranks, as JSON: {"0:<parameter name>" or
    "1:<state path>": {"local": {rank: shape}, "offset": {rank: offset}}}."""
    import json

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import _named, abstract_train_state, train_state_shardings

    cfg = get_config(arch)
    world = 512 if multi_pod else 256
    trees = abstract_train_state(cfg)[:2]
    out: dict = {}
    for rank in ranks:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod)
            for which, (tree, shardings) in enumerate(zip(trees, train_state_shardings(cfg, mesh))):
                flat = _named(tree)
                for name, sh in _named(shardings).items():
                    key = f"{which}:{name.replace('.', '/') if which else name}"
                    local = distribute_tensor(flat[name], mesh, sh.placements).to_local()
                    _, offset = compute_local_shape_and_global_offset(flat[name].shape, mesh,
                                                                      sh.placements)
                    rec = out.setdefault(key, {"local": {}, "offset": {}})
                    rec["local"][rank] = list(local.shape)
                    rec["offset"][rank] = list(offset)
        finally:
            dist.destroy_process_group()
    Path(out_json).write_text(json.dumps(out))


def run_ranks(tmp: Path, mode: str, inputs: dict, world: int, device: str = "cpu",
              timeout: float = 120) -> list:
    """``world`` ranks of this script in MODE ``mode``, each a process of its
    own with ``timeout`` seconds, rendezvous through a file under ``tmp``;
    their outputs, by rank.  A rank that fails or outlives its limit fails
    the caller, with its output."""
    import os
    import subprocess

    np.savez(tmp / "in.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world),
                               str(tmp / "rendezvous"), str(tmp / "in.npz"), str(tmp), device],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited with {p.returncode}:\n{log[-3000:]}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def main(argv) -> int:
    if argv[0] == "layout":
        import json
        layout(argv[1], argv[2] == "1", json.loads(argv[3]), argv[4])
        return 0
    mode, rank, world, init_file, in_npz, out_dir, device = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)                # every rank shares the one card
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        data = np.load(in_npz, allow_pickle=False)
        out = {"coded": coded, "train": train, "serve": serve}[mode](rank, world, data, dev)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
