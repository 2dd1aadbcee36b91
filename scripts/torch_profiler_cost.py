"""What ``chip_smoke.device_kernel_ms`` costs on the host: gemma3-27b whole
(bfloat16, random from seed 0, 4,714 kernel launches a decode step at
B = 4) on one card, the same steps run bare and under the profiler, at 5,
2 and 1 counted steps.

    python3 scripts/torch_profiler_cost.py

Needs a card with about 60 GB free; prints one line per count: the bare
steps' seconds, the profiled call's seconds, its launches and kernel
milliseconds a step.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config("gemma3-27b"), device="cuda")
    caches = model.init_cache(4, 64)
    tok = torch.as_tensor(np.arange(1, 5)[:, None], device="cuda")
    pos = iter(range(64))

    def step():
        return model.decode_step(tok, caches, next(pos))

    for _ in range(3):
        step()
    for n in (5, 2, 5, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        bare = time.perf_counter() - t0
        t0 = time.perf_counter()
        busy_ms, _, launches, _ = chip_smoke.device_kernel_ms(step, n)
        print(f"{n} steps: bare {bare:.3f} s, under the profiler {time.perf_counter() - t0:.3f} s, "
              f"{launches:.0f} launches and {busy_ms:.3f} ms of kernels a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
