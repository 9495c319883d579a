"""Where K2's scan time goes on wide rows: builds of ``csrc/flat_scan.cu``
with parts of the scan cut, timed in turns with the whole kernel on one
slab of ``chip_smoke.py``'s phase 2h (16,384 queries against Gaussian
rows) at each width. Needs one CUDA card; run from the repository's root:

    python3 scripts/k2_split.py [widths] [--against DIR ...]

``widths`` e.g. 256,768 (default: every phase-2h width); ``--against``
adds the whole kernel of each other checkout DIR (a ``git archive`` of the
parent, or a design variant) to the turns, built the same way.

The cuts are source patches keyed to the scan the checkout holds:

* the streamed ``mma.sync`` scan (``flat_scan_streamed_kernel``, the tree
  of commit 7b24e3c; run the script from a ``git archive`` of it):
  ``stage`` (the ``cp.async`` staging and its block barrier alone: the
  products and the bins update cut), ``products`` (staging and products:
  the bins update cut);
* the ``wgmma`` scan of wide rows (``flat_scan_wide_kernel``): ``no_bins``
  (the bins update cut), ``no_products`` (that and the products: the TMA
  ring, the query fragments' loads and the consumers' barriers alone).

Every cut keeps the rest of the kernel as it is; outputs are not checked.
Each build holds ``flat_scan.cu`` and the headers alone (the IVF scans are
left out, so the copies build in seconds). The whole kernel and each cut
run in turns (whole, cuts..., cuts reversed, whole), each line giving the
means and both readings.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from annsearch_tpu_torch.ops import _cuda  # noqa: E402

#: the streamed mma.sync scan: (anchor, replacement)
STREAMED = {
    "stage": [("    mma::cp_async_commit();\n\n    const unsigned char* st = smem + ",
               "    mma::cp_async_commit();\n    if (t >= 0) continue;\n\n"
               "    const unsigned char* st = smem + ")],
    "products": [("    if (ch == nch - 1) {\n      const float* snr",
                  "    if (t >= 0) continue;\n    if (ch == nch - 1) {\n      const float* snr")],
}
_NO_BINS = ("      if (k.c == nch - 1) bins_update(k);\n",
            "      if (k.c == nch - 1 && k.c < 0) bins_update(k);\n")
_PRODUCT = "hopper::wgmma_m64n128k16(part, a[ai], desc, first ? 0 : 1);\n"
_NO_PRODUCTS = ("          " + _PRODUCT, "          if (k.c < 0) " + _PRODUCT)
#: the wgmma scan of wide rows
WIDE = {"no_bins": [_NO_BINS], "no_products": [_NO_BINS, _NO_PRODUCTS]}

_BUILD = ("from annsearch_tpu_torch.ops import _cuda\n"
          "try:\n    _cuda.load_library()\n"
          "except AttributeError:\n    pass   # the IVF entries are not in this build\n"
          "print(_cuda._build_dir() / _cuda._LIB_NAME)\n")


def _bind(path):
    lib = ctypes.CDLL(path)
    for fn_name, argtypes in _cuda._SIGNATURES.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def build_variants(against=()):
    src = open(os.path.join("annsearch_tpu_torch", "csrc", "flat_scan.cu")).read()
    variants = STREAMED if STREAMED["stage"][0][0] in src else WIDE
    builds = [("whole", ".", []), *((n, ".", p) for n, p in variants.items()),
              *((os.path.basename(os.path.normpath(d)), d, []) for d in against)]
    procs = {}
    for name, base, patches in builds:
        root = os.path.join("_archive", f"k2var_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(base, "annsearch_tpu_torch"),
                        os.path.join(root, "annsearch_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        csrc = os.path.join(root, "annsearch_tpu_torch", "csrc")
        for f in os.listdir(csrc):
            if f.endswith(".cu") and f != "flat_scan.cu":
                os.remove(os.path.join(csrc, f))
        path = os.path.join(csrc, "flat_scan.cu")
        text = open(path).read()
        for old, new in patches:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        open(path, "w").write(text)
        procs[name] = subprocess.Popen([sys.executable, "-c", _BUILD], cwd=root,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        path = out.strip().splitlines()[-1] if out.strip() else ""
        if not os.path.exists(path):
            raise RuntimeError(f"the {name} build failed:\n{out}")
        libs[name] = _bind(path)
    return libs


def in_turns(label, fn, libs):
    own = _cuda.load_library
    cuts = [k for k in libs if k != "whole"]
    order = ["whole", *cuts, *cuts[::-1], "whole"]
    got = {k: [] for k in libs}
    for who in order:
        _cuda.load_library = lambda who=who: libs[who]
        try:
            got[who].append(cs._cuda_ms(fn, reps=3))
        finally:
            _cuda.load_library = own
    parts = ", ".join(f"{k} {np.mean(v):.3f} ms ({v[0]:.3f} / {v[1]:.3f})"
                      for k, v in got.items())
    print(f"SPLIT {label}: {parts}", flush=True)


def main():
    from annsearch_tpu_torch.ops import flat_scan_fused as ff
    from annsearch_tpu_torch.utils.dist import Dist

    args = sys.argv[1:]
    against = args[args.index("--against") + 1:] if "--against" in args else []
    args = args[:args.index("--against")] if "--against" in args else args
    widths = {int(w) for w in args[0].split(",")} if args else {s[0] for s in cs.K2W_SLABS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    dev = torch.device("cuda:0")
    t0 = time.time()
    libs = build_variants(against)
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    for d, passes, n, kbs in cs.K2W_SLABS:
        if d not in widths:
            continue
        x = torch.randn(n, d, generator=gen, device=dev)
        q, sn = x[: cs.K2W_NQ], (x * x).sum(1)
        kb = kbs[0]
        in_turns(f"d {d} passes {passes} kb {kb} (nq {cs.K2W_NQ}, n {n})",
                 lambda: ff.flat_topk_fused(q, x, kb, Dist.EUCLIDEAN, x_sqnorm=sn,
                                            passes=passes), libs)
        del x, q, sn
        torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
