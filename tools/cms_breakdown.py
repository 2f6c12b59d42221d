"""Where the Count-Min kernel's time goes, on one card: the port's
``cms_cluster_kernel`` cut short after each of its phases.

    python3 tools/cms_breakdown.py

Builds probe kernels from ``src/repro_torch/kernels/csrc/cms_update.cu``
itself (its device functions, up to the cluster kernel, are taken from the
source text, so the probes count exactly as the port does) into
``build/cms_breakdown.so``, and times on the stream's batch 0 R join column
(100,000 keys, the StreamConfig sketch: depth 4, width 2048), with the
port's grid (clusters of 8 CTAs of 256 threads, a CTA to about 1,024 rows):

  count          zero the tables, count the CTA's rows, stop;
  count+fill     the same after a zero fill of the output (torch.zeros);
  +syncs         count+fill, then the kernel's two cluster barriers;
  +merge loads   +syncs with the merge's distributed-shared-memory loads;
  port           the port's wrapper (``sketch_update.cms_update``);
  empty          an empty kernel (``sketch_update.empty_launch``).

Each is device ms a call by CUDA-graph replay (``chip_smoke._graph_ms``).
Prints the card and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "cms_update.cu"

PROBE = r'''
// stop: 0 after the count, 1 after the two cluster barriers, 2 after the
// merge's loads as well (their sums kept alive, never stored)
__global__ void __launch_bounds__(THREADS) probe_kernel(Params p, int stop) {
  __shared__ uint4 tab4[SMEM_WORDS / 4];
  uint32_t* tab = reinterpret_cast<uint32_t*>(tab4);
  cg::cluster_group cluster = cg::this_cluster();
  const int words4 = (p.n_tables * static_cast<int>(p.width) + 3) / 4;
  for (int w = threadIdx.x; w < words4; w += THREADS) tab4[w] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const long long begin = static_cast<long long>(blockIdx.x) * p.rows_per_cta;
  const long long end = min(begin + p.rows_per_cta, p.n);
  count_tables<THREADS, false>(p, 0, p.n_tables, begin, end, tab);
  if (stop == 0) return;
  cluster.sync();
  if (stop == 2) {
    const unsigned rank = cluster.block_rank();
    const int slice4 = (words4 + CS - 1) / CS;
    const int lo4 = static_cast<int>(rank) * slice4;
    const int hi4 = min(lo4 + slice4, words4);
    for (int w4 = lo4 + threadIdx.x; w4 < hi4; w4 += THREADS) {
      uint32_t sum = 0u;
#pragma unroll
      for (int q = 0; q < CS; ++q) sum += load_rank(tab4 + w4, (rank + q) % CS).x;
      if (sum == 0xFFFFFFFFu) p.out[0] = sum;
    }
  }
  cluster.sync();
}
}  // namespace

extern "C" int probe_launch(const void* rows, long long n, const unsigned* seeds, unsigned width,
                            void* out, int stop, void* stream) {
  Params p{};
  p.cols[0] = 0;
  for (int i = 0; i < 4; ++i) p.seeds[i] = seeds[i];
  p.rows = static_cast<const int32_t*>(rows);
  p.n = n;
  p.out = static_cast<uint32_t*>(out);
  p.stride = 1;
  p.depth = 4;
  p.n_tables = 4;
  p.group = 4;
  p.width = width;
  int lg = 0;
  while ((1ull << lg) < width) ++lg;
  p.magic = static_cast<uint32_t>(((1ull << 32) * ((1ull << lg) - width)) / width + 1);
  p.shift = lg - 1;
  long long clusters = (n + static_cast<long long>(CS) * ROWS_PER_CTA - 1) /
                       (static_cast<long long>(CS) * ROWS_PER_CTA);
  if (clusters > MAX_CLUSTERS) clusters = MAX_CLUSTERS;
  p.rows_per_cta = (n + clusters * CS - 1) / (clusters * CS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * CS), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, probe_kernel, p, stop);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
'''


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cms_breakdown.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import _graph_ms, _zipf_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_update as su
    from repro_torch.stream.sketch import _row_seeds

    text = CSRC.read_text()
    src = text[:text.index("// Tables that fit in shared memory")] + PROBE
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "cms_breakdown.cu", out_dir / "cms_breakdown.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    probe = ctypes.CDLL(str(so)).probe_launch
    probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint),
                      ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    seeds, width = _row_seeds(0, 4), 2048
    c_seeds = (ctypes.c_uint * 4)(*seeds)
    batch0 = _zipf_batch(np.random.default_rng(0), 0, 100_000, 25_000, 100_000, 2.0)
    col = torch.from_numpy(batch0["R"][:, 1].astype(np.int32)).to(dev)

    def run(stop, fill):
        out = (torch.zeros if fill else torch.empty)((4, width), dtype=torch.int32, device=dev)
        err = probe(col.data_ptr(), col.shape[0], c_seeds, width, out.data_ptr(), stop,
                    torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    times = {
        "count": _graph_ms(lambda: run(0, False), 50),
        "count+fill": _graph_ms(lambda: run(0, True), 50),
        "+syncs": _graph_ms(lambda: run(1, True), 50),
        "+merge loads": _graph_ms(lambda: run(2, True), 50),
        "port": _graph_ms(lambda: su.cms_update(col, seeds, width), 50),
        "empty": _graph_ms(lambda: su.empty_launch(dev), 50),
    }
    print(smi)
    print(json.dumps({"cms_breakdown_ms": times, "n": col.shape[0], "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
