"""Diagnostic builds of the weight-ring kernels, timed on the card against
the kernels as they stand.

    python -m llm_inference_tpu_torch.tools.ring_variants [--variants a,b]

Each variant is a copy of one kernel's source (`qmm4_gemv.cu`, K1's int4
GEMV; `layer_tail.cu`, K6; `layer_fused.cu`, K12) and the headers of
`csrc/` under `build/ring_variants/`, with one part of the kernel cut out
or one plan setting changed by a text patch, built into a library of its
own (nvcc, the flags of `_build`). A patch whose text is no longer in the
source stops the tool. The variants:

  K1's int4 GEMV (`qmm4_launch` on LLaMA-2-7B's wqkv at M = 1 and 8 with
  the norm prologue, lm_head at M = 1 and 8, one tp = 2 rank's wo and
  wqkv at M = 1):
  noload        the weight producer issues no copies (the consumers run
                on what the slots hold): the products and the rest,
                without the copies;
  noproducts    the consumers skip their products (they still wait for
                and release every slot): the copies and the rest;
  noprologue    the rows are not read or written: the kernel without its
                prologue;
  halfproducts  the second product of each chunk's pair left out;
  unwidened     the codes enter the products unwidened (wrong sums, the
                same products);
  nopdl         an ordinary launch, not a dependent one;
  ringcons      groups of 32k codes on the ring's own consumer (K6's and
                K12's: the rows as A, float32 in shared memory split into
                bf16 hi + lo, the codes as B), with the plan search of
                groups of 16 and 8; the rest of the kernel as it is.

  K6 (`layer_tail_fused`: LLaMA-2-7B widths at M = 1, 4, 8, 16 and 32
  in groups of 128, at M = 1 and 8 in groups of 16, one tp = 2 rank's
  widths at M = 1 and 8) and K12 (`layer_kernel` at M = 1, int4 g = 128
  and int8 LLaMA-2-7B layers over a bf16 and an int8 cache, position
  191 of 512 slots):
  k6qw1, k12qw1  every phase's stages of one chunk a consumer warp
                 (`make_plan`, not `make_plan_qw2`).

Every case calls the kernel's library and the variant's in turns (kernel,
variant, variant, kernel; `k1_turns.turns`; a layer a call in turn, so
the codes come from HBM) and prints both means in us. nopdl, ringcons and
the plan variants compute the kernel's function: the largest difference
of their output from the kernel's is printed beside them. The others'
outputs are wrong by design. Needs a card and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import torch

from llm_inference_tpu_torch.ops.kernels import _build
from llm_inference_tpu_torch.tools.k1_turns import rows, turns, weight

OUT = _build.BUILD_DIR.parent / "ring_variants"
BF16 = torch.bfloat16
K6_PLAN = "  code = make_plan_qw2(a.r.pl, a.M, nblk, 0, 0);\n"
K12_PLAN = "  code = make_plan_qw2(a.r.pl, 1, nblk, a.H * 4, att);\n"


# variant -> (source, [(file, text in the source, its replacement)], right)
PATCHES = {
    "noload": ("qmm4_gemv.cu", [
        ("weight_ring.cuh", "          for (int j = 0; j < ng; ++j)\n",
         "          for (int j = 0; j < 0; ++j)\n"),
        ("weight_ring.cuh",
         "boxes * p.ub * (slabs * kSlab + units * p.bg * 4));",
         "0 * boxes * p.ub * (slabs * kSlab + units * p.bg * 4));"),
        ("weight_ring.cuh", "      for (int j = 0; j < slabs; ++j) {\n",
         "      for (int j = 0; j < 0; ++j) {\n"),
        ("weight_ring.cuh", "      for (int u = 0; u < units; ++u) {\n",
         "      for (int u = 0; u < 0; ++u) {\n"),
    ], False),
    "noproducts": ("qmm4_gemv.cu", [
        ("qmm4_gemv.cu", "      while (c < c1) {\n",
         "      while (false && c < c1) {\n"),
    ], False),
    "noprologue": ("qmm4_gemv.cu", [
        ("qmm4_gemv.cu", "  norm_rows<!SMALL>(a, S);\n", "  named_sync();\n"),
    ], False),
    "halfproducts": ("qmm4_gemv.cu", [
        ("qmm4_gemv.cu",
         "            mma::mma_16816(d[i][b], A1, B[b][2], B[b][3]);\n", ""),
    ], False),
    "unwidened": ("qmm4_gemv.cu", [
        ("qmm4_gemv.cu",
         "          const uint32_t A0[4] = {(w0 & mask) ^ bias, "
         "(w1 & mask) ^ bias,",
         "          const uint32_t A0[4] = {w0, w1, w0 ^ w1, w0 + w1};\n"
         "          const uint32_t A1[4] = {w1, w0, w0 - w1, w0 | w1};\n"
         "          const uint32_t X0[4] = {(w0 & mask) ^ bias, "
         "(w1 & mask) ^ bias,"),
        ("qmm4_gemv.cu", "          const uint32_t A1[4] = {((w0 >> 8)",
         "          const uint32_t X1[4] = {((w0 >> 8)"),
    ], False),
    "nopdl": ("qmm4_gemv.cu", [
        ("qmm4_gemv.cu", "  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n"),
    ], True),
    "ringcons": ("qmm4_gemv.cu", [
        ("qmm4_gemv.cu", "  const bool small = (K / G) % 32 != 0;\n",
         "  const bool small = true;\n"),
        ("qmm4_gemv.cu", "  if ((K / G) % 32)\n    return launch<true>",
         "  if (true)\n    return launch<true>"),
    ], True),
    "k6qw1": ("layer_tail.cu", [("layer_tail.cu", K6_PLAN,
                                  K6_PLAN.replace("_qw2", ""))], True),
    "k12qw1": ("layer_fused.cu", [("layer_fused.cu", K12_PLAN,
                                   K12_PLAN.replace("_qw2", ""))], True),
}
# K1's cases: (name, K, N, the main path's prologue choice, M, layers a turn)
K1_CASES = [("wqkv", 4096, 12288, True, 1, 8),
            ("wqkv", 4096, 12288, True, 8, 8),
            ("lm_head", 4096, 32000, False, 1, 2),
            ("lm_head", 4096, 32000, False, 8, 2),
            ("tp2 wo", 2048, 4096, False, 1, 8),
            ("tp2 wqkv", 4096, 6144, True, 1, 8)]
DEPTH = 4                             # K6's and K12's layers


def build(names, table=PATCHES):
    """One library a variant of `table`, from patched copies of the
    sources."""
    nvcc = _build._nvcc()
    procs = []
    for name in names:
        src, patches, _ = table[name]
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        files = [src] + [f.name for f in _build.CSRC_DIR.glob("*.cuh")]
        text = {f: (_build.CSRC_DIR / f).read_text() for f in files}
        for f, old, new in patches:
            if old not in text[f]:
                raise SystemExit(f"variant {name}: {f} no longer holds "
                                 f"{old.strip()!r}")
            text[f] = text[f].replace(old, new)
        for f, t in text.items():
            (d / f).write_text(t)
        procs.append((name, subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared",
             str(d / src), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for entry, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


class _Swap:
    """The kernel library with the variant's entries in place of its own."""

    def __init__(self, kernel, variant):
        self.kernel, self.variant = kernel, variant

    def __getattr__(self, name):
        if name != "kernels_error_string" and hasattr(self.variant, name):
            return getattr(self.variant, name)
        return getattr(self.kernel, name)


def through(lib, run):
    """fn(i) = run(i) with `lib` as the wrappers' kernel library."""
    def fn(i):
        _build._lib = lib
        return run(i)
    return fn


def max_diff(a, b):
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def compare(v, fk, fv):
    """`v us (kernel us[, max diff])` of variant v in turns with the
    kernel, or the error of a launch the variant refuses (a plan that
    does not fit)."""
    want = [o.clone() for o in fk(1)]
    try:
        got = fv(1)
    except RuntimeError as e:
        return f"{v} refused ({e})"
    diff = (f", max diff {max_diff(got, want):.3g}" if PATCHES[v][2]
            else "")
    k, t = turns(fk, fv)
    return f"{v} {t * 1e3:.1f} (kernel {k * 1e3:.1f}{diff})"


def k1_cases(kernel, libs, gen):
    st = torch.cuda.current_stream().cuda_stream
    for name, K, N, pro, M, depth in K1_CASES:
        qt = weight(4, K, N, gen, depth=depth)
        x, kw = rows(M, K, pro, gen)
        res, gam = kw.get("residual"), kw.get("norm_gamma")

        def call(lib):
            out = torch.empty((M, N), dtype=BF16, device="cuda")
            xo = torch.empty_like(x) if pro else None

            def fn(i):
                li = i % depth
                code = lib.qmm4_launch(
                    x.data_ptr(), None if res is None else res.data_ptr(),
                    None if gam is None else gam.data_ptr(),
                    qt.q.data_ptr() + li * N * K // 2,
                    qt.scale.data_ptr() + li * N * qt.groups * 4, None,
                    out.data_ptr(), None if xo is None else xo.data_ptr(),
                    M, K, N, qt.groups, 1e-5, st)
                if code:
                    raise RuntimeError(f"qmm4_launch: CUDA error {code}")
                return (out,) if xo is None else (out, xo)
            return fn
        got = [compare(v, call(kernel), call(lib))
               for v, lib in libs.items()]
        print(f"K1 int4 GEMV {name} M={M}: " + "  ".join(got) + " us",
              flush=True)
        del qt
        torch.cuda.empty_cache()


def layer_cases(kernel, libs, gen, seed):
    import dataclasses

    from llm_inference_tpu_torch.config import QuantConfig, llama2_7b
    from llm_inference_tpu_torch.models import llama
    from llm_inference_tpu_torch.ops import kvcache
    from llm_inference_tpu_torch.ops.kernels import layer_fused as k12
    from llm_inference_tpu_torch.ops.kernels import quant_matmul as k1
    cfg = dataclasses.replace(llama2_7b(), num_layers=DEPTH)
    H, eps = cfg.hidden_size, cfg.rms_norm_eps
    cases = []
    # K6: (name, Ko, I, group size, M)
    for name, Ko, I, gs, Ms in (("7b", H, 11008, 128, (1, 4, 8, 16, 32)),
                                ("7b", H, 11008, 16, (1, 8)),
                                ("tp2", H // 2, 5504, 128, (1, 8))):
        ws = (weight(4, Ko, H, gen, gs, DEPTH),
              weight(4, H, 2 * I, gen, gs, DEPTH),
              weight(4, I, H, gen, gs, DEPTH))
        for M in Ms:
            a = (torch.randn((M, H), generator=gen, device="cuda").to(BF16),
                 torch.randn((M, Ko), generator=gen, device="cuda").to(BF16),
                 *ws, (1 + 0.1 * torch.randn((H,), generator=gen,
                                             device="cuda")).to(BF16), eps)
            cases.append((f"K6 {name} g={gs} M={M}", "layer_tail.cu",
                          lambda i, a=a: k1.layer_tail_fused(*a, i % DEPTH)))
    S, pos, Hkv, D = 512, 191, cfg.num_kv_heads, cfg.head_dim
    shape = (DEPTH, 1, Hkv, S, D)
    caches = {
        "bf16": kvcache.KVCache(
            k=torch.randn(shape, generator=gen, device="cuda").to(BF16),
            v=torch.randn(shape, generator=gen, device="cuda").to(BF16)),
        "int8": kvcache.KVCache(
            k=torch.randint(-128, 128, shape, generator=gen, device="cuda",
                            dtype=torch.int8),
            v=torch.randint(-128, 128, shape, generator=gen, device="cuda",
                            dtype=torch.int8),
            k_scale=torch.rand((DEPTH, 1, S, Hkv), generator=gen,
                               device="cuda") / 64 + 1e-3,
            v_scale=torch.rand((DEPTH, 1, S, Hkv), generator=gen,
                               device="cuda") / 64 + 1e-3, bits=8)}
    h = torch.randn((1, 1, H), generator=gen, device="cuda").to(BF16)
    res = torch.randn((1, 1, H), generator=gen, device="cuda").to(BF16)
    cos_t, sin_t = llama.rope_table(cfg, S, torch.device("cuda"))
    cos, sin = cos_t[pos][None, None], sin_t[pos][None, None]
    positions = torch.tensor([[pos]], dtype=torch.int32, device="cuda")
    for qcfg in (QuantConfig(weights="int4", group_size=128,
                             quantize_embedding=True),
                 QuantConfig(weights="int8", quantize_embedding=True)):
        lay = llama.prepare_params(llama.init_params_quantized(
            cfg, qcfg, seed=seed, device="cuda"))["layers"]
        for kv, cache in caches.items():
            cases.append((
                f"K12 {qcfg.weights} + {kv} KV M=1", "layer_fused.cu",
                lambda i, lay=lay, cache=cache: k12.layer_kernel(
                    cfg, h, res, lay, cache, i % DEPTH, positions, cos,
                    sin)))
    try:
        for name, src, run in cases:
            got = [compare(v, through(kernel, run),
                           through(_Swap(kernel, lib), run))
                   for v, lib in libs.items() if PATCHES[v][0] == src]
            if got:
                print(f"{name}: " + "  ".join(got) + " us", flush=True)
    finally:
        _build._lib = kernel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(PATCHES),
                    help="comma-separated, of " + ", ".join(PATCHES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = set(names) - set(PATCHES)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("ring_variants needs a CUDA card")
    shutil.rmtree(OUT, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    kernel = _build.lib()
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    k1_libs = {v: lib for v, lib in libs.items()
               if PATCHES[v][0] == "qmm4_gemv.cu"}
    if k1_libs:
        k1_cases(kernel, k1_libs, gen)
    if len(k1_libs) < len(libs):
        layer_cases(kernel, libs, gen, args.seed)


if __name__ == "__main__":
    main()
