"""Where the two head kernels' time goes, on the card: each kernel as built
against probe builds of the same source that drop parts of the work (their
outputs are wrong; they are only timed).

    python scripts/head_kernels_probe.py

ROI-cosine (``protoasnet_tpu_torch/csrc/roi_cosine.cu``):
- ``no_products``: stages every position of feat and occ through the ring
  but runs no ``mma`` (the epilogue still loads the prototypes, sums and
  writes roi and sim);
- ``one_product`` (fp32 only): one TF32 product (hi * hi) a k8 step
  instead of three: what the 3xTF32 split costs;
- ``no_store``: computes everything but writes no roi;
- ``stream_only``: ``no_products`` and ``no_store`` together: the ring
  streaming feat and occ, the prototype sums and the cluster's exchange.

L2 + min (``protoasnet_tpu_torch/csrc/l2_min.cu``):
- ``no_products``: stages x and w and sums x^2 and w^2, but runs none of
  the dot products' FMAs;
- ``no_exchange``: computes the products, but stores none of the partials
  into the other blocks' shared memory and writes no dist (the cluster's
  barriers stay);
- ``stage_only``: both: the staging, the barriers and the minima.

Design variants (correct outputs at the shapes timed here; ``v_``): the
ROI kernel with a smaller register budget (``v_lb4``: four blocks an SM for
a ring of 3-4 stages, five for a shorter one, instead of two and three;
``v_lb3``: three and four; ``v_lb2``: two for every ring), bf16 stages of
128 positions (``v_kc128``, two stages), its n8 tiles counted from the
block's prototypes at run time (``v_tiles_from_p``) instead of all five
fixed at compile time, or its prototype count per block fixed at 40 too
(``v_full``: right only where P is a multiple of 40, as at both heads);
the L2 kernel in clusters of 1 block (``v_c1``, each warp over two stages
of 32 d) instead of 2, or with one block an SM by registers (``v_lb1``: no
128-register cap, no spills, the same grid). Both kernels without the relaxed cluster barrier on entry
(``v_no_entry_barrier``: nothing then waits until every block of the
cluster has started). The occupancy query's clusters resident at once are
printed for each plan.

Each probe is the source with text substitutions, built with the package's
``nvcc`` flags into ``protoasnet_tpu_torch/_build/probe/`` and called
through the wrapper (``roi_cosine_cuda``, ``l2_min_cuda``), so the launch
is planned as in the port. Times are device times from ``torch.profiler``
(kernels whose name contains ``roi_cosine_kernel`` or ``l2_min_kernel``)
at the served head shapes of ``chip_smoke.py`` phase 2 (batch 128): the
video head (S=8*14*14, P=40, D=256) and the image head (S=7*7, P=40,
D=512) in bf16 and fp32, and ProtoPNet's head (S=7*7, P=30, D=512, fp32),
printed one line per shape and dtype after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from protoasnet_tpu_torch.ops import cuda_build  # noqa: E402
from protoasnet_tpu_torch.ops import l2_min_cuda as l2_wrapper  # noqa: E402
from protoasnet_tpu_torch.ops import roi_cosine_cuda as roi_wrapper  # noqa
from scripts.head_kernels_ab import HEADS, device_ms  # noqa: E402

# (T < 0 never holds; the compiler cannot drop what it guards)
ROI_NO_PRODUCTS = [("      multiply<In>(acc, fs,",
                    "      if (p.S < 0) multiply<In>(acc, fs,")]
ROI_ONE_PRODUCT = [("          mma_tf32(d, alo[mt], bh0, bh1);\n"
                    "          mma_tf32(d, ahi[mt], bl0, bl1);\n", "")]
ROI_NO_STORE = [("              p.roi[(static_cast<int64_t>(n)",
                 "              if (p.S < 0) p.roi[(static_cast<int64_t>(n)")]
L2_NO_PRODUCTS = [("      products(acc, buf, pq, rg);",
                   "      if (q.S < 0) products(acc, buf, pq, rg);")]
L2_NO_EXCHANGE = [("      *reinterpret_cast<float4*>(dst) =",
                   "      if (q.S < 0) *reinterpret_cast<float4*>(dst) ="),
                  ("    if (tid < kST)\n      cluster.map_shared_rank",
                   "    if (tid < kST && q.S < 0)\n      cluster.map_shared_rank"),
                  ("    if (tid < kPT)\n      for (int r = 0; r < C; ++r)\n"
                   "        cluster.map_shared_rank",
                   "    if (tid < kPT && q.S < 0)\n      for (int r = 0; r < C; "
                   "++r)\n        cluster.map_shared_rank"),
                  ("      if (p0 + pl < q.P) {\n        dist_n[",
                   "      if (p0 + pl < q.P && q.S < 0) {\n        dist_n[")]
# design variants (correct outputs at the heads timed): the ROI kernel's
# register budget (blocks an SM by registers: 4 / 5, 3 / 4 or 2 / 2 for
# long / short rings instead of 2 / 3), bf16 stages of 128 positions (two),
# n8 tiles from P, the prototype count fixed; the L2 kernel without its
# register cap; both without the entry barrier
ROI_LB4 = [("{ return ns >= 3 ? 2 : 3; }", "{ return ns >= 3 ? 4 : 5; }")]
ROI_LB3 = [("{ return ns >= 3 ? 2 : 3; }", "{ return ns >= 3 ? 3 : 4; }")]
ROI_LB2 = [("{ return ns >= 3 ? 2 : 3; }", "{ return ns >= 3 ? 2 : 2; }")]
ROI_TILES_FROM_P = [("  const int nt = kNT;", "  const int nt = (np + 7) / 8;")]
ROI_FULL = [("  const int np = min(kPG, p.P - p0);", "  const int np = kPG;")]
ROI_NO_ENTRY_BARRIER = [("  cluster_arrive_relaxed();\n", ""),
                        ("  cluster_wait();\n  float* const dst",
                         "  float* const dst")]
L2_LB1 = [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")]
L2_NO_ENTRY_BARRIER = [("  cluster_arrive_relaxed();\n", ""),
                       ("    if (s0 == 0) cluster_wait();\n", "")]
ROI_KC128 = [("kKC = sizeof(In) == 2 ? 64 : 32;", "kKC = sizeof(In) == 2 ? 128 : 32;"),
             ("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;")]
PROBES = {
    "roi_cosine.cu": {"no_products": ROI_NO_PRODUCTS,
                      "one_product": ROI_ONE_PRODUCT,
                      "no_store": ROI_NO_STORE,
                      "stream_only": ROI_NO_PRODUCTS + ROI_NO_STORE,
                      "v_lb4": ROI_LB4, "v_lb3": ROI_LB3,
                      "v_lb2": ROI_LB2, "v_kc128": ROI_KC128,
                      "v_tiles_from_p": ROI_TILES_FROM_P, "v_full": ROI_FULL,
                      "v_no_entry_barrier": ROI_NO_ENTRY_BARRIER},
    "l2_min.cu": {"no_products": L2_NO_PRODUCTS,
                  "no_exchange": L2_NO_EXCHANGE,
                  "stage_only": L2_NO_PRODUCTS + L2_NO_EXCHANGE,
                  "v_lb1": L2_LB1,
                  "v_no_entry_barrier": L2_NO_ENTRY_BARRIER},
}
# wrapper constants a build needs (module attribute: value); variants of
# the wrapper alone (the kernel as built): L2 clusters of 4 and of 1 block
PLAN = {"v_c1": {"_D_TARGET": 512}}
WRAPPER_ONLY = {"l2_min.cu": ("v_c1",)}
FP32_ONLY = ("one_product",)


def build(source: str, name: str) -> Path:
    src = (cuda_build.CSRC_DIR / source).read_text()
    for old, new in PROBES[source][name]:
        if old not in src:
            raise RuntimeError(f"probe {name}: {old!r} is not in {source}")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    cu, so = out / f"{stem}_{name}.cu", out / f"{stem}_{name}.so"
    cu.write_text(src)
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
           str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe {name} failed to build:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build {stem} {name}] {line.strip()}", flush=True)
    return so


def bind(wrapper, so: Path) -> ctypes.CDLL:
    """A probe library with the argument types the wrapper's own has."""
    real = wrapper._lib()
    lib = ctypes.CDLL(str(so))
    for fn in ("roi_cosine_forward", "roi_cosine_error_string",
               "l2_min_forward", "l2_min_error_string"):
        if hasattr(real, fn) and hasattr(lib, fn):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


def probe_times(wrapper, libs, fn, name):
    own = wrapper._lib
    times = []
    for probe, lib in libs.items():
        saved = {k: getattr(wrapper, k) for k in PLAN.get(probe, {})}
        try:
            wrapper._lib = lambda lib=lib: lib
            for k, v in PLAN.get(probe, {}).items():
                setattr(wrapper, k, v)
            ms = device_ms(fn, name)
        finally:
            wrapper._lib = own
            for k, v in saved.items():
                setattr(wrapper, k, v)
        times.append(f"{probe} " + ("not measured" if ms is None
                                    else f"{ms:.4f} ms"))
    return ", ".join(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("head_kernels_probe: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    jobs = [(src, name) for src in PROBES for name in PROBES[src]]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda j: build(*j), jobs)))
    roi_libs = {"kernel": roi_wrapper._lib(),
                **{name: bind(roi_wrapper, built["roi_cosine.cu", name])
                   for name in PROBES["roi_cosine.cu"]}}
    l2_libs = {"kernel": l2_wrapper._lib(),
               **{name: bind(l2_wrapper, built["l2_min.cu", name])
                  for name in PROBES["l2_min.cu"]},
               **{name: l2_wrapper._lib()
                  for name in WRAPPER_ONLY["l2_min.cu"]}}
    for src, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {src} kernel] {line.strip()}", flush=True)
    for head in ("video", "image"):
        n, s, p, d = HEADS[head]
        for elem in (2, 4):
            pl = roi_wrapper.plan(n, s, p, d, elem)
            print(f"roi_cosine {head} {elem}-byte: {pl}, clusters resident "
                  f"at once {roi_wrapper.active_clusters(elem, s, pl.cluster)}"
                  f" of {pl.blocks // pl.cluster}", flush=True)
    n, s, p, d = HEADS["ppnet"]
    for target in (256, 512):
        saved, l2_wrapper._D_TARGET = l2_wrapper._D_TARGET, target
        pl = l2_wrapper.plan(n, p, d)
        l2_wrapper._D_TARGET = saved
        print(f"l2_min ppnet: {pl}, clusters resident at once "
              f"{l2_wrapper.active_clusters(pl.cluster)} of "
              f"{pl.blocks // pl.cluster}", flush=True)
    dev = torch.device("cuda")
    with torch.inference_mode():
        for head in ("video", "image"):
            n, s, p, d = HEADS[head]
            g = torch.Generator(device=dev).manual_seed(1)
            occ32 = torch.rand((n, s, p), device=dev, generator=g) * 0.05
            feat32 = torch.randn((n, s, d), device=dev, generator=g)
            protos = torch.rand((p, d), device=dev, generator=g)
            for dtype in (torch.bfloat16, torch.float32):
                occ, feat = occ32.to(dtype), feat32.to(dtype)
                libs = {k: v for k, v in roi_libs.items()
                        if dtype == torch.float32 or k not in FP32_ONLY}
                line = probe_times(
                    roi_wrapper, libs,
                    lambda: roi_wrapper.roi_cosine_cuda(occ, feat, protos),
                    "roi_cosine_kernel")
                print(f"roi_cosine {head} {str(dtype)[6:]}: {line}",
                      flush=True)
        n, s, p, d = HEADS["ppnet"]
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.sigmoid(torch.randn((n, s, d), device=dev, generator=g))
        w = torch.rand((p, 1, 1, d), device=dev, generator=g)
        line = probe_times(l2_wrapper, l2_libs,
                           lambda: l2_wrapper.l2_min_cuda(x, w),
                           "l2_min_kernel")
        print(f"l2_min ppnet float32: {line}", flush=True)


if __name__ == "__main__":
    main()
