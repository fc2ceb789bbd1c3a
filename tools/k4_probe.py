#!/usr/bin/env python3
"""Where K4a (fused_mlp_int8.cu's first kernel: fc1, GELU, requant) loses
its time on the card: probe builds of a fused_mlp_int8.cu, timed at EVA-g's
shape (M = 128 x 257, [M, 1408] x 6144, gelu_poly) in turns
(p1 p2 p3 p3 p2 p1).

    python3 tools/k4_probe.py hirest_tpu_torch/ops/csrc

- p1: the kernel as it is;
- p2: without the epilogue's dequant and GELU, quotients and code stores;
  the rows' maxima of the raw accumulators, their exchange across the
  cluster, the scales and the hand-offs to the store warps stay;
- p3: p2 with each landed stage's wgmmas issued twice.

p1 - p2 is the epilogue the products do not hide; p3 ~ 2 x p2 says the
main loop is bound by the tensor cores, p3 ~ p2 by what feeds them. The
probes are cut along the source's `// k4_probe: begin <span>` and
`// k4_probe: end <span>` lines: `value` (a value's dequant and GELU),
`codes` (the quotients and the codes' writes into the box), `store` (the
box's TMA store) and `products` (a K step's wgmmas). Needs one CUDA GPU and
nvcc; the builds go to build/k4_probe/ and are not used by anything else.
Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from hirest_tpu_torch.ops import build, quant  # noqa: E402

OUT = REPO / "build" / "k4_probe"
M, C, F = 128 * 257, 1408, 6144  # EVA-g's rows at B = 128, width, hidden
SPANS = ("value", "codes", "store", "products")

# p2's value: the raw accumulator, whose maxima the exchange still takes
VALUE = re.compile(r"fc1_value<kAct>\(([^,]+),[^;]*\)")


def span_re(name: str) -> re.Pattern:
    """A marked span, its marker lines included."""
    return re.compile(rf"^[ \t]*// k4_probe: begin {name}\n(.*?)"
                      rf"^[ \t]*// k4_probe: end {name}\n",
                      re.MULTILINE | re.DOTALL)


def probes(source: str) -> dict:
    """The three sources: p1 as given, p2 and p3 rewritten along the
    source's marked spans."""
    for name in SPANS:
        if not span_re(name).search(source):
            raise SystemExit(f"k4_probe: no marked span {name!r} in the "
                             f"source")
    p2 = span_re("value").sub(lambda m: VALUE.sub(r"(float)\1", m.group(1)),
                              source)
    p2 = span_re("codes").sub("", p2)
    p2 = span_re("store").sub("", p2)
    p3 = span_re("products").sub(lambda m: m.group(1) * 2, p2)
    return {"p1": source, "p2": p2, "p3": p3}


def compile_all(csrc: Path, source: str) -> dict:
    """Each probe built into build/k4_probe/, its ptxas lines printed; K4a's
    entry point by probe."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in probes(source).items():
        src = OUT / f"fused_mlp_int8_{name}.cu"
        src.write_text(text)
        lib = OUT / f"libfused_mlp_int8_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k4_probe: nvcc failed for {name}:\n{log}")
        lines = [line.split("info    :")[-1].strip() for line in
                 log.splitlines() if "hidden" in line.lower() or
                 "Used" in line or "bytes stack" in line]
        print(f"[k4-probe] {name} ptxas: {' | '.join(lines)}")
        fn = ctypes.CDLL(str(lib)).hirest_mlp_int8_hidden
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
    source = (csrc / "fused_mlp_int8.cu").read_text()
    fns = compile_all(csrc, source)
    # what the trunk hands K4a, as chip_smoke.py's mlp_inputs builds it:
    # row-quantized activations, weights quantized from 0.02-scale floats
    g = torch.Generator(device="cuda").manual_seed(28)
    h_q, h_s = quant.dyn_quant_rows_ref(
        torch.randn((M, C), generator=g, device="cuda"))
    w1, s1 = quant.quantize_weight(
        0.02 * torch.randn((F, C), generator=g, device="cuda"))
    b1 = 0.02 * torch.randn(F, generator=g, device="cuda")
    codes = torch.empty((M, F), dtype=torch.int8, device="cuda")
    scales = torch.empty((M, F // 1024), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        err = fn(h_q.data_ptr(), h_s.data_ptr(), w1.data_ptr(),
                 s1.data_ptr(), b1.data_ptr(), codes.data_ptr(),
                 scales.data_ptr(), M, F, 0, stream)
        if err:
            raise SystemExit(f"k4_probe: launch failed, CUDA error {err}")

    names = list(fns)
    ms = {p: [] for p in names}
    for p in names + names[::-1]:
        ms[p].append(timed(lambda: call(fns[p])))
    line = ", ".join(f"{p} {a:.4f} / {b:.4f} ms" for p, (a, b) in ms.items())
    print(f"[k4-probe] {card}: K4a [{M},{C}]x[{C},{F}] gelu_poly "
          f"({csrc}): {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
