"""The kernel build, without a toolkit: processes that start at once share
one build.

A stub ``nvcc`` (a Python script first on the PATH) writes each file it is
asked for slowly, over a random time, and fails if an object it is given is
not whole, so that a build that reads another process's half-written object
fails.  It logs every call: processes that shared one build compiled each
source once and linked once.
"""

import os
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]

STUB = '''#!{python}
import random, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({calls!r}, "a") as log:
    log.write(("link" if "-shared" in args else "compile") + "\\n")
for obj in (a for a in args if a.endswith(".o") and a != out):
    if open(obj).read() != "object whole\\n":
        with open({failures!r}, "a") as f:
            f.write(obj + "\\n")
        sys.exit(1)
with open(out, "w") as f:
    f.write("object ")
    f.flush()
    time.sleep(random.uniform(0.05, 0.6))
    f.write("whole\\n")
'''

# run as a file: spawned children import their parent's main module
RACE = '''
import multiprocessing as mp
import sys
from pathlib import Path


def build(root, barrier, results):
    from repro_torch.kernels import _build
    _build.BUILD_ROOT = Path(root)
    barrier.wait()
    try:
        results.put(str(_build.build()))
    except Exception as exc:
        results.put(f"error: {exc!r}")


if __name__ == "__main__":
    root, n = sys.argv[1], int(sys.argv[2])
    ctx = mp.get_context("spawn")
    barrier, results = ctx.Barrier(n), ctx.Queue()
    procs = [ctx.Process(target=build, args=(root, barrier, results)) for _ in range(n)]
    for p in procs:
        p.start()
    got = [results.get(timeout=240) for _ in procs]
    for p in procs:
        p.join()
    print("\\n".join(got))
'''


def test_concurrent_first_builds_share_one_build(tmp_path):
    n = 4
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls, failures = tmp_path / "calls.log", tmp_path / "failures.log"
    stub = bin_dir / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, calls=str(calls),
                                failures=str(failures)))
    stub.chmod(0o755)
    race = tmp_path / "race.py"
    race.write_text(RACE)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(race), str(tmp_path / "kernels"), str(n)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lib = tmp_path / "kernels" / _build._source_hash() / "libs2c2_kernels.so"
    assert out.stdout.split() == [str(lib)] * n, out.stdout
    assert not failures.exists(), failures.read_text()
    # one process compiled and linked; the others found its library
    assert sorted(calls.read_text().split()) == ["compile"] * len(_build.SOURCES) + ["link"]
    assert lib.read_text() == "object whole\n"
    assert not list(lib.parent.glob("*.o"))
