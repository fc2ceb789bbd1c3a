#!/usr/bin/env python3
"""Where G1 loses its time on the card: probe builds of an int8_gemm.cu,
timed at EVA-g's bf16 products in turns (p1 p2 p3 .. p3 p2 p1).

    python3 tools/g1_probe.py hirest_tpu_torch/ops/csrc
    python3 tools/g1_probe.py build/parent/hirest_tpu_torch/ops/csrc

The first design (its epilogue in series with the products, as the port
held it before the cluster kernel; take it with `git archive 03dfa9e
hirest_tpu_torch/ops/csrc | tar -x -C build/parent`):

- p1: the kernel as it is;
- p2: without the epilogue's global stores and residual reads (each
  warpgroup keeps one 16-byte store a tile, so the compiler keeps the
  dequant into the staging tile);
- p3: p2 with each landed stage's wgmmas issued twice.

The cluster kernel (its epilogue warp stores the tile by TMA):

- p1: the kernel as it is;
- p2: without the consumers' dequant (each thread writes one word of the
  staging tile, so the compiler keeps the products);
- p3: p2 with each landed stage's wgmmas issued twice;
- p4: p2 with a staging tile of one 64-column box, which leaves room for
  a fourth ring stage, and only that box of each tile stored: a quarter
  of the output's bytes (products without a residual only).

p1 - p2 is the epilogue the products do not hide; p3 ~ 2 x p2 says the
main loop is bound by the tensor cores, p3 ~ p2 by what feeds it. Needs
one CUDA GPU and nvcc; the builds go to build/g1_probe/ and are not used
by anything else. Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hirest_tpu_torch.ops import build  # noqa: E402

OUT = REPO / "build" / "g1_probe"
M = 128 * 257  # EVA-g's rows at B = 128
# (name, K, N, with the residual, the first design's variant: 0 256-wide
# tiles one block an SM, 1 128-wide two blocks an SM; the cluster kernel
# is variant 0 for all four)
SHAPES = (("qkv", 1408, 4224, False, 0), ("fc1", 1408, 6144, False, 0),
          ("fc2 + residual", 6144, 1408, True, 0),
          ("out + residual", 1408, 1408, True, 1))

# the first design's rewrites
STORE_FROM = "      constexpr int kChunks = BN / 8;   // 16-byte chunks a row\n"
STORE_TO = "        *reinterpret_cast<uint4*>(out + at) = y;\n      }\n"
ONE_STORE = """      if (threadIdx.x % 128 == 0 && m0 + wg * 64 < M)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + wg * 64) * N + n0) =
            *reinterpret_cast<const uint4*>(st + wg * 64 * L::kRow);
"""
PRODUCTS = """      for (int k = 0; k < kBK / kKStep; ++k)
        wgmma_s8<BN>(acc, smem_desc(a0 + s * kATile + k * kKStep),
                     smem_desc(b0 + s * L::kBTile + k * kKStep), kt | k);
"""
TWICE = """      for (int k = 0; k < 2 * (kBK / kKStep); ++k)
        wgmma_s8<BN>(acc,
                     smem_desc(a0 + s * kATile + k % (kBK / kKStep) * kKStep),
                     smem_desc(b0 + s * L::kBTile +
                               k % (kBK / kKStep) * kKStep), kt | k);
"""
# the cluster kernel's
DEQUANT_FROM = "        const bool has_res = res != nullptr;\n"
DEQUANT_TO = "          *p1 = bf16_pack(v10, v11);\n        }\n"
NO_DEQUANT = """        *reinterpret_cast<int*>(staging + staged_at(r0, 2 * q)) =
            acc[0] ^ acc[kBN / 2 - 1];
"""
CLUSTER_PRODUCTS = """        for (int k = 0; k < kBK / kKStep; ++k)
          wgmma_s8<kBN>(acc, smem_desc(a0 + s * P::kATile + k * kKStep),
                        smem_desc(b0 + s * P::kBTile + k * kKStep), kt | k);
"""
BOX_STAGING = ("  static constexpr int kStaging = kStaged ? kBoxes * kBoxBytes : 0;",
               "  static constexpr int kStaging = kStaged ? kBoxBytes : 0;")
BOX_STORE = ("    for (int x = 0; x < kBoxes && n0 + x * kBox < N; ++x)",
             "    for (int x = 0; x < 1 && n0 + x * kBox < N; ++x)")
CLUSTER_TWICE = """        for (int k = 0; k < 2 * (kBK / kKStep); ++k)
          wgmma_s8<kBN>(acc,
                        smem_desc(a0 + s * P::kATile +
                                  k % (kBK / kKStep) * kKStep),
                        smem_desc(b0 + s * P::kBTile +
                                  k % (kBK / kKStep) * kKStep), kt | k);
"""


def once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"g1_probe: expected one {old.splitlines()[0]!r} "
                         f"in the source, found {text.count(old)}")
    return text.replace(old, new)


def cut(text: str, start: str, end: str, new: str) -> str:
    """text with the span from `start` to the end of `end` replaced."""
    a = text.find(start)
    b = text.find(end, a)
    if a < 0 or b < 0:
        raise SystemExit(f"g1_probe: no {start.strip()!r} ... "
                         f"{end.strip()!r} span in the source")
    return text[:a] + new + text[b + len(end):]


def is_first_design(source: str) -> bool:
    return STORE_FROM in source


def probes(source: str) -> dict:
    """The three sources: p1 as given, p2 and p3 rewritten, for the first
    design or the cluster kernel, whichever the source holds."""
    if is_first_design(source):
        p2 = cut(source, STORE_FROM, STORE_TO, ONE_STORE)
        return {"p1": source, "p2": p2, "p3": once(p2, PRODUCTS, TWICE)}
    p2 = cut(source, DEQUANT_FROM, DEQUANT_TO, NO_DEQUANT)
    return {"p1": source, "p2": p2,
            "p3": once(p2, CLUSTER_PRODUCTS, CLUSTER_TWICE),
            "p4": once(once(p2, *BOX_STAGING), *BOX_STORE)}


def compile_all(csrc: Path, source: str) -> dict:
    """Each probe built into build/g1_probe/, its ptxas lines printed; the
    entry points by probe. The cluster kernel's takes the split-K blocks
    after the variant."""
    OUT.mkdir(parents=True, exist_ok=True)
    n_ints = 5 if is_first_design(source) else 6
    procs = {}
    for name, text in probes(source).items():
        src = OUT / f"int8_gemm_{name}.cu"
        src.write_text(text)
        lib = OUT / f"libint8_gemm_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"g1_probe: nvcc failed for {name}:\n{log}")
        regs = [line.split("info    :")[-1].strip() for line in
                log.splitlines() if "Used" in line or "bytes stack" in line]
        print(f"[g1-probe] {name} ptxas: {' | '.join(regs)}")
        fn = ctypes.CDLL(str(lib)).hirest_int8_gemm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong] + [
            ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def timed(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    csrc = Path(sys.argv[1]).resolve()
    source = (csrc / "int8_gemm.cu").read_text()
    first = is_first_design(source)
    libs = compile_all(csrc, source)
    g = torch.Generator(device="cuda").manual_seed(24)
    stream = torch.cuda.current_stream().cuda_stream
    for name, k, n, with_res, variant in SHAPES:
        x_q = torch.randint(-127, 128, (M, k), generator=g, device="cuda",
                            dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                            dtype=torch.int8)
        x_s = torch.rand(M, generator=g, device="cuda") * 0.05 + 1e-3
        w_s = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
        b = torch.randn(n, generator=g, device="cuda")
        res = (torch.randn((M, n), generator=g, device="cuda")
               .to(torch.bfloat16) if with_res else None)
        out = torch.empty((M, n), dtype=torch.bfloat16, device="cuda")
        tail = (variant,) if first else (0, 1)  # variant (and splits)

        def call(fn):
            err = fn(x_q.data_ptr(), k, x_s.data_ptr(), w_q.data_ptr(), k,
                     w_s.data_ptr(), b.data_ptr(),
                     None if res is None else res.data_ptr(),
                     out.data_ptr(), M, n, k, 0, *tail, stream)
            if err:
                raise SystemExit(f"g1_probe: launch failed, CUDA error {err}")

        names = [p for p in libs if p != "p4" or not with_res]
        ms = {p: [] for p in names}
        for p in names + names[::-1]:
            ms[p].append(timed(lambda: call(libs[p])))
        line = ", ".join(f"{p} {a:.4f} / {c:.4f} ms" for p, (a, c) in
                         ms.items())
        design = f"variant {variant}" if first else "the cluster kernel"
        print(f"[g1-probe] {card}: {name} [{M},{k}]x[{k},{n}] bf16, "
              f"{design}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
