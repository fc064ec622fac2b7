"""Time the grouped matmul's tensor-core design at each of its tile heights.

``csrc/moe_gmm.cu`` picks BM = 64 rows of C a tile for C <= 64 and
BM = 256 above. This script builds the same source with one more C
entry point that launches the design at a BM the caller names (64, 128
or 256), times each BM beside ``torch.bmm`` at moonshot-v1-16b-a3b's
serve shapes and at a deep contraction (D = 8192, where a tile's
prologue and epilogue weigh least), and checks each output against
``torch.bmm``'s. Needs a CUDA card and ``nvcc``:

    python scripts/gmm_tile_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch import cuda_build  # noqa: E402

ENTRY = """
extern "C" int gmm_wgmma_at(const void* x, const void* w, void* out, int E,
                            int C, int D, int F, int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 64) return tc::launch<64>(x, w, out, E, C, D, F, st);
  if (bm == 128) return tc::launch<128>(x, w, out, E, C, D, F, st);
  return tc::launch<256>(x, w, out, E, C, D, F, st);
}
"""
SHAPES = ((64, 480, 2048, 1408), (64, 480, 1408, 2048), (64, 8, 2048, 1408),
          (64, 8, 1408, 2048), (64, 480, 8192, 1408))


def build() -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "gmm_tile_variants.cu"
    src.write_text((cuda_build.CSRC / "moe_gmm.cu").read_text() + ENTRY)
    lib = cuda_build.BUILD_DIR / "libgmm_tile_variants.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).gmm_wgmma_at
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    launch = build()
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for e, c, d, f in SHAPES:
        x = (torch.randn((e, c, d), generator=gen, device="cuda")
             * 0.5).bfloat16()
        w = (torch.randn((e, d, f), generator=gen, device="cuda")
             * d ** -0.5).bfloat16()
        want = torch.bmm(x, w)
        out = torch.empty_like(want)
        cells = [f"bmm={ms(lambda: torch.bmm(x, w)):.6f}"]
        for bm in (64, 128, 256):
            args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                    bm, stream)
            rc = launch(*args)
            torch.cuda.synchronize()
            if rc != 0:
                sys.exit(f"BM={bm} launch failed: {rc}")
            err = float((out.float() - want.float()).abs().max())
            cells.append(f"BM{bm}={ms(lambda: launch(*args)):.6f} "
                         f"(max_abs_diff_vs_bmm={err:.3g})")
        print(f"{e}x{c}x{d}x{f}: " + " ".join(cells), flush=True)


if __name__ == "__main__":
    main()
