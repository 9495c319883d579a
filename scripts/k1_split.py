"""Where K1's time goes: builds of ``csrc/ivf_scan.cu`` with parts of the
kernel cut, timed in turns with the whole kernel on the captured calls of
``chip_smoke.py``'s paths. Needs one CUDA card; run from the repository's
root:

    python3 scripts/k1_split.py [phases]     # phases: 2g,3,11 (the default)

The cuts are source patches keyed to the kernel the checkout holds:

* the ``mma.sync`` scan (the tree of commit f9973f0; run the script from a
  ``git archive`` of it): ``stage`` (staging only: the products and the
  per-chunk epilogue cut), ``products`` (staging and products: the
  epilogue cut);
* the ``wgmma`` scan: ``no_sel`` (the fold's final selection cut),
  ``no_epi`` (that and the per-chunk epilogue), ``no_products`` (those and
  the products: the prologue, the TMA ring and the conversion of the
  cells alone).

Every cut keeps the rest of the kernel as it is; outputs are not checked.
The whole kernel and each cut run in turns (whole, cuts..., cuts reversed,
whole) on phase 2g's wide exact call, phase 3's K1a call and phase 11's
forest K1d-f32 call; each line gives the means and both readings.
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

#: the mma.sync scan: (anchor, replacement)
OLD = {
    "stage": [("    if (t + 1 < nsteps) load(t + 1);\n",
               "    if (t + 1 < nsteps) load(t + 1);\n    if (t >= 0) continue;\n")],
    "products": [("    if (cb != ncb - 1) continue;\n", "    if (t >= 0) continue;\n")],
}
_NO_SEL = ("      fold_select<kDepth>(sv_s + slot * kSurv, si_s + slot * kSurv, lane, kb, "
           "out_d + ob,\n                          out_i + ob);\n",
           "      if (lane == 0) out_d[ob] = sv_s[slot * kSurv];\n")
_NO_EPI = ("    // epilogue of chunk ch on the accumulator map\n",
           "    if (ch >= 0) continue;\n")
_NO_PRODUCTS = ("              if constexpr (kInt8) {\n                hopper::wgmma_m64n32k32_s8",
                "              if (ch >= 0) { first = false; continue; }\n"
                "              if constexpr (kInt8) {\n                hopper::wgmma_m64n32k32_s8")
#: the wgmma scan
NEW = {
    "no_sel": [_NO_SEL],
    "no_epi": [_NO_SEL, _NO_EPI],
    "no_products": [_NO_SEL, _NO_EPI, _NO_PRODUCTS],
}


def build_variants():
    src = open(os.path.join("annsearch_tpu_torch", "csrc", "ivf_scan.cu")).read()
    variants = OLD if OLD["stage"][0][0] in src else NEW
    procs = {}
    for name, patches in variants.items():
        root = os.path.join("_archive", f"var_{name}")
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree("annsearch_tpu_torch", os.path.join(root, "annsearch_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(root, "annsearch_tpu_torch", "csrc", "ivf_scan.cu")
        text = src
        for old, new in patches:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        open(path, "w").write(text)
        code = ("from annsearch_tpu_torch.ops import _cuda; _cuda.load_library(); "
                "print(_cuda._build_dir() / _cuda._LIB_NAME)")
        procs[name] = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {"whole": _cuda.load_library()}
    for name, p in procs.items():
        out, _ = p.communicate()
        lib = ctypes.CDLL(out.strip().splitlines()[-1])
        for fn_name, argtypes in _cuda._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def in_turns(label, fn, libs):
    own = _cuda.load_library
    cuts = [k for k in libs if k != "whole"]
    order = ["whole", *cuts, *cuts[::-1], "whole"]
    got = {k: [] for k in libs}
    for who in order:
        _cuda.load_library = lambda who=who: libs[who]
        try:
            got[who].append(cs._cuda_ms(fn))
        finally:
            _cuda.load_library = own
    parts = ", ".join(f"{k} {np.mean(v):.3f} ms ({v[0]:.3f} / {v[1]:.3f})"
                      for k, v in got.items())
    print(f"SPLIT {label}: {parts}", flush=True)


def main():
    import annsearch_tpu_torch as at
    from annsearch_tpu_torch.ops import ivf_scan_fused as tsf
    from annsearch_tpu_torch.utils.data import (generate_clustered_data, generate_data,
                                                subsample_with_noise)

    phases = (sys.argv[1] if len(sys.argv) > 1 else "2g,3,11").split(",")
    os.environ.pop("ANNSEARCH_NO_EXACT_FALLBACK", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    dev = torch.device("cuda:0")
    t0 = time.time()
    libs = build_variants()
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)

    if "2g" in phases:   # wide rows, the exact tier
        x_np, _ = generate_clustered_data(cs.W_N, cs.W_DIMS[0], 20, seed=cs.SEED)
        x = torch.as_tensor(x_np, device=dev)
        q = torch.as_tensor(subsample_with_noise(x_np, cs.W_NQ, seed=cs.SEED), device=dev)
        index = at.build_ivf_index(x, nlist=16, seed=cs.SEED, device=dev)
        with cs._Capture("ivf_cell_scan_f32_exact") as cap:
            index.query(q, cs.K, nprobe=4)
        a, kw = cap.args["ivf_cell_scan_f32_exact"]
        in_turns("phase 2g K1c-f32 wide (d 4,224)",
                 lambda: tsf.ivf_cell_scan_f32_exact(*a, **kw), libs)
        del index, x, q, a, kw, cap

    if "3" in phases:    # K1a
        x_np, _ = generate_clustered_data(cs.N, cs.D, cs.NCLUST, seed=cs.SEED)
        q = torch.as_tensor(subsample_with_noise(x_np, cs.NQ, seed=cs.SEED), device=dev)
        x = torch.as_tensor(x_np, device=dev)
        del x_np
        index = at.build_ivf_pq_index(x, nlist=cs.NLIST, m=cs.M, seed=cs.SEED, device=dev)
        with cs._Capture("ivf_cell_scan") as cap:
            index.query(q, cs.K, nprobe=cs.NPROBE, approx=True)
        a, kw = cap.args["ivf_cell_scan"]
        print(f"K1a call: R {a[0].shape[0]} maxq {a[0].shape[1]}", flush=True)
        in_turns("phase 3 K1a", lambda: tsf.ivf_cell_scan(*a, **kw), libs)
        del index, x, q, a, kw, cap

    if "11" in phases:   # Annoy p2's last K1d-f32 call
        g_np, _ = generate_data("lowrank", cs.G_N, cs.G_D, 12, seed=42, intrinsic_dim=16)
        x = torch.as_tensor(g_np[:cs.T_N], device=dev)
        del g_np
        index = at.build_annoy_index(x, n_trees=16, leaf=64, seed=cs.SEED, device=dev)
        with cs._Capture("ivf_cell_scan_f32_fold") as cap:
            at.query_annoy_self(index, cs.T_K, 2, None, True)
        a, kw = cap.args["ivf_cell_scan_f32_fold"]
        cnt = a[2]
        print(f"forest call: R {a[0].shape[0]} maxq {a[0].shape[1]} seg {a[4].shape[1]}, "
              f"valid rows a task row {cnt.float().mean().item():.1f} on average", flush=True)
        in_turns("phase 11 forest K1d-f32 (annoy p2, d 32)",
                 lambda: tsf.ivf_cell_scan_f32_fold(*a, **kw), libs)
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
