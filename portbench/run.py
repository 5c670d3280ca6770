"""Benchmark of the PyTorch/CUDA port: one run of one cell, one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices;
BENCHMARK.json names the cells. Without a card it exits with code 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel and build caches stay inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench-cache", sub)
os.environ["USE_FLAX"] = "0"
# One host thread for CPU math: the host-bound requests run on shared cores.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def keep_heap():
    """Have glibc's allocator serve every block from its heap and keep
    what is freed there (mallopt M_MMAP_MAX 0, M_TRIM_THRESHOLD 2 GiB).
    By default each array over the mmap threshold (a request's audio,
    features and words run to tens of MB) is a fresh mapping that the
    kernel faults in page by page and unmaps when freed: 7-8 s of kernel
    time in a 51 s long-form window on an H100 host whose kernel is
    sandboxed, a cost that moves with the host's load. This process
    only: the programs it starts (nvcc, nvidia-smi) keep the defaults."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):  # not glibc: its defaults stand
        return
    m_trim_threshold, m_mmap_max = -1, -4
    mallopt(m_mmap_max, 0)
    mallopt(m_trim_threshold, 2**31 - 1)


keep_heap()
sys.path.insert(0, ROOT)

from portbench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
