#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) if it fails:

1. device   — the card's name, and its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build    — compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels  — ``gram_norm`` (triangular and full grid) and ``direct_norm``
              against their plain PyTorch versions in f32 and bf16 at the
              main path's shapes, a ragged shape and the LM head; the three
              flash attention kernels (forward, dQ, dK/dV) against theirs in
              f32 and bf16 at the main path's shape, a ragged S, MHA, D=32
              and D=128, a window and a softcap, and the backward run twice
              for bitwise-equal results;
4. exact    — llama3.2-1b at full width in f32: ``Engine.step([Norms(),
              Grads()])``, unfused and with ``AttnCfg.flash``, against a
              per-example loop of plain (unfused) backward passes, and its
              summed gradient against a plain batch backward;
5. main     — the main path: llama3.2-1b at full width in bf16, B=8,
              S=512, three DP-SGD steps ``[Norms, Clip, Noise, GNS]`` each
              followed by an AdamW update, with the kernel launches of the
              forward and of each backward pass counted, and CUDA events
              around the unfused attention core (forward and backward);
6. flash    — the same three steps with ``AttnCfg.flash=True`` on the same
              parameters, batches and noise seed: the attention runs
              through the flash kernels, whose launches per pass are
              counted; step 0's loss against phase 5's;
7. moe-exact — phi3.5-moe at full width, 2 layers, f32, B=32, S=64 (16
              dispatch groups; capacity drops may occur):
              ``Engine.step([Norms(), Grads()])`` against the per-example
              gradients of the batched loss (B ``autograd.grad`` calls over
              one plain batched forward, since capacity dispatch couples
              examples), and its summed gradient against the batch backward;
8. moe      — the MoE path: phi3.5-moe at its published widths, 2 layers,
              bf16, B=32, S=256, three DP-SGD steps ``[Norms, Clip, Noise,
              GNS]`` each followed by AdamW, the launches of each pass
              counted (3 ``segmented_norm`` launches per layer in the norms
              backward, none in the reweighted one) and CUDA events around
              every segmented launch;
9. segmented — ``segmented_norm`` against its plain version in f32 and bf16
              at the MoE path's gate/up (4096→6400) and down (6400→4096)
              shapes with the segment ids of its first step, a ragged T and
              p_out, all rows dropped, empty segments and one segment, each
              run twice for bitwise-equal results;
10. table   — each kernel's time, plain time and bound at its path's
              shapes, the gram kernel at the direct kernel's shapes (the LM
              head's, where the forced direct route is not the cheaper one,
              and wk/wv's), and the flash kernels beside PyTorch's
              ``scaled_dot_product_attention`` (timed as a yardstick only;
              the port never calls it).

Every kernel is called through its ``repro_torch.kernels.ops`` wrapper,
the one the main path goes through. A kernel's bound is the least time the
card could take for the function, whichever route computes it: the input
bytes over the HBM rate or the fewer operations of the two routes
(``ops.flop_estimate``; per segment for ``segmented_norm``,
``ops.segmented_flop_estimate``, over the rows this run keeps) over the
bf16 tensor-core peak, whichever is longer.

The flash path's step time, peak memory and attention time are logged
beside the main path's from the same call, and the MoE path's step time,
peak memory and segmented kernel time per step after them. TF32 is off
for matmuls and cuDNN throughout, so the f32 plain versions are full f32.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the kernel table as JSON, and the line before that the
``nvidia-smi`` reading.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S = 8, 512            # main path batch and sequence length
EXACT_B, EXACT_S = 4, 256
MOE_LAYERS = 2           # phi3.5-moe depth cut 32 → 2 (the reference's
                         # own probe depth); widths as published
MOE_B, MOE_S = 32, 256   # MoE path: ng=16 groups of bg=2, capacity 88
MOE_EXACT_B, MOE_EXACT_S = 32, 64
STEPS = 3
PEAK_BYTES_PER_S = 3.35e12                      # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,         # dense tensor-core bf16
              "torch.float32": 67e12}           # f32 outside tensor cores
TOL = {"torch.float32": 1e-4,    # summation order only
       "torch.bfloat16": 5e-4}   # bf16 inputs, whose products are exact
                                 # in f32; both sides accumulate in f32 in
                                 # another order (worst reading 5.92e-5,
                                 # gram at the head). A 128-wide p_out
                                 # column of G dropped or doubled at the
                                 # head moves the norm by ~1/1002 = 1e-3
FLASH_TOL = {"torch.float32": 1e-4,   # of each output's max |value|:
                                      # summation order only
             "torch.bfloat16": 1e-2}  # O, dQ, dK, dV round to bf16
                                      # (2^-8 = 3.9e-3 of the value) and
                                      # the kernels round P and dS to bf16
                                      # for the tensor cores; both sides
                                      # accumulate in f32
LSE_TOL = 1e-4                        # of max |lse|, both types: f32 sums
                                      # of the same bf16/f32 products
LOSS_TOL = 5e-3                       # relative, flash vs unfused step-0
                                      # loss in bf16: the two routes round
                                      # the attention to bf16 at different
                                      # points; more than ~1 bf16 ulp of
                                      # the loss would be another function
SOURCES = {"gram_norm": ("src/repro_torch/csrc/gram_norm.cu",
                         "src/repro/kernels/gram_norm.py:297"),
           "direct_norm": ("src/repro_torch/csrc/direct_norm.cu",
                           "src/repro/kernels/direct_norm.py:141"),
           "segmented_norm": ("src/repro_torch/csrc/segmented_norm.cu",
                              "src/repro/kernels/segmented_norm.py:204"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:182"),
           "flash_attention_bwd_dq": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:337"),
           "flash_attention_bwd_dkv": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:361")}
NORM_KERNELS = ("gram_norm", "direct_norm")
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# (B, Hq, Hkv, S, D, softcap, window) of the flash kernel checks: the main
# path's shape first
FLASH_CASES = [(B, 32, 8, S, 64, None, None), (2, 8, 2, 200, 64, None, None),
               (2, 4, 4, 256, 64, None, None), (2, 4, 4, 192, 32, None, None),
               (2, 8, 2, 256, 128, None, None), (2, 8, 2, S, 64, None, 128),
               (2, 8, 2, 256, 64, 50.0, None), (1, 4, 2, 333, 64, 30.0, 100)]


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want):
    return ((got - want).abs() / want.abs()).max().item()


def layer_shapes(cfg):
    """(p_in, p_out) of every tapped dense layer of one block that the
    gram/direct dispatch takes: attention, then the MLP or the MoE router
    (the MoE experts go to ``segmented_norm``)."""
    a = cfg.attn
    d = cfg.d_model
    hq, hkv = a.n_heads_p * a.head_dim, a.n_kv * a.head_dim
    attn = [(d, hq), (d, hkv), (d, hkv), (hq, d)]
    if cfg.moe is not None:
        return attn + [(d, cfg.moe.n_experts)]
    f = cfg.mlp.d_ff
    return attn + [(d, f), (d, f), (f, d)]


def with_flash(cfg):
    """``cfg`` with ``AttnCfg.flash`` set."""
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             flash=True))


def main_path_launches(cfg, s):
    """{kernel: {(p_in, p_out): launches per step}} from the port's own
    dispatch: each block's dense layers by ``pick_method``, the head
    forced to direct (``nn/embedding.lm_head``)."""
    from repro_torch.core.norms import pick_method
    out = {"gram_norm": {}, "direct_norm": {}}
    for pi, po in layer_shapes(cfg):
        k = pick_method(s, pi, po) + "_norm"
        out[k][(pi, po)] = out[k].get((pi, po), 0) + cfg.n_layers
    head = (cfg.d_model, cfg.vocab)
    out["direct_norm"][head] = out["direct_norm"].get(head, 0) + 1
    return out


def pass_launches(expected, cfg):
    """Launches of every counted kernel in the tapped forward, the norms
    backward and the reweighted backward of one step: the norm kernels in
    the norms backward only (with MoE, three segmented launches per layer:
    gate, up, down); with ``AttnCfg.flash``, one forward launch per layer
    in the forward and one dQ and one dK/dV launch per layer in each
    backward."""
    from repro_torch.kernels import ops
    flash = cfg.attn.flash
    zero = dict.fromkeys(ops.launch_counts(), 0)
    norms = {k: sum(v.values()) for k, v in expected.items()}
    if cfg.moe is not None:
        norms["segmented_norm"] = 3 * cfg.n_layers
    bwd = ({"flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers} if flash else {})
    return ({**zero, "flash_attention": cfg.n_layers if flash else 0},
            {**zero, **norms, **bwd}, {**zero, **bwd})


class AttentionEvents:
    """CUDA events around the attention core of every layer: the forward
    call, and in each backward pass the span from the cotangent's arrival
    at the core's output to the last cotangent leaving q, k and v (tensor
    hooks, which run on the autograd stream in the order the grads are
    formed)."""

    def __init__(self, fn):
        self.fn = fn
        self.fwd, self.bwd = [], []

    def _event(self):
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __call__(self, q, k, v, *a, **kw):
        e0 = self._event()
        y = self.fn(q, k, v, *a, **kw)
        self.fwd.append((e0, self._event()))
        if y.requires_grad:
            y.register_hook(lambda g: self.bwd.append(("start",
                                                       self._event())))
            for x in (q, k, v):
                x.register_hook(lambda g: self.bwd.append(("end",
                                                           self._event())))
        return y

    def clear(self):
        self.fwd.clear()
        self.bwd.clear()

    def ms(self):
        """(forward ms, backward ms) summed over the calls since clear()."""
        fwd = sum(a.elapsed_time(b) for a, b in self.fwd)
        bwd, start, last = 0.0, None, None
        for kind, e in self.bwd + [("start", None)]:
            if kind == "start":
                if start is not None and last is not None:
                    bwd += start.elapsed_time(last)
                start, last = e, None
            else:
                last = e
        return fwd, bwd


def time_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {_build.lib_path()} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(cfg, errs):
    """Every kernel against its plain version; ``errs`` collects the max
    abs error of each kernel at the main path's shapes in bf16."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.direct_norm import direct_norm_ref
    from repro_torch.kernels.ref import gram_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = [(B, S, pi, po) for pi, po in sorted(set(layer_shapes(cfg)))]
    cases = [(3, 37, 80, 200)] + main + [(2, S, cfg.d_model, cfg.vocab)]
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[str(dt)]
        for b, s, pi, po in cases:
            h = torch.randn(b, s, pi, generator=gen, device="cuda").to(dt)
            z = torch.randn(b, s, po, generator=gen, device="cuda").to(dt)
            want_g = gram_norm_ref(h, z)
            want_d = direct_norm_ref(h, z)
            got = {"gram_norm": ops.gram_norm(h, z),
                   "gram_norm_full": ops.gram_norm(h, z, triangular=False),
                   "direct_norm": ops.direct_norm(h, z)}
            torch.cuda.synchronize()
            want = {"gram_norm": want_g, "gram_norm_full": want_g,
                    "direct_norm": want_d}
            line = []
            for k, v in got.items():
                r = rel_err(v, want[k])
                line.append(f"{k} rel {r:.2e}")
                if not r <= tol:
                    raise AssertionError(
                        f"{k} disagrees with its plain version at "
                        f"{(b, s, pi, po)} {dt}: rel err {r} > {tol}")
                if dt == torch.bfloat16 and (b, s, pi, po) in main + cases[-1:]:
                    base = k.replace("_full", "")
                    errs[base] = max(errs.get(base, 0.0),
                                     (v - want[k]).abs().max().item())
            r_tf = rel_err(got["gram_norm"], got["gram_norm_full"])
            line.append(f"tri-vs-full rel {r_tf:.2e}")
            if not r_tf <= tol:
                raise AssertionError(f"triangular vs full grid: {r_tf}")
            log(f"[kernels] {str(dt)[6:]} {(b, s, pi, po)}: "
                + ", ".join(line) + f" (tol {tol})")
            del h, z
        # gram against direct: the identity the kernels rest on
        r = rel_err(got["gram_norm"], got["direct_norm"])
        log(f"[kernels] {str(dt)[6:]} gram vs direct at the head shape: "
            f"rel {r:.2e} (tol {tol})")
        if not r <= tol:
            raise AssertionError(f"gram vs direct disagree: {r}")


def flash_inputs(b, hq, hkv, s, d, dt, gen):
    """q (B, Hq, S, D), k, v (B, Hkv, S, D) and dO as the model passes
    them: (B, H, S, D) views of (B, S, H, D) tensors."""
    import torch

    def draw(h):
        return torch.randn(b, s, h, d, generator=gen,
                           device="cuda").to(dt).transpose(1, 2)
    return draw(hq), draw(hkv), draw(hkv), draw(hq)


def phase_flash_kernels(errs):
    """The flash kernels against their plain versions: O and lse, then dQ,
    dK and dV on the plain forward's O and lse; the backward twice, for
    bitwise-equal results."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dt)]
        for case in FLASH_CASES:
            b, hq, hkv, s, d, cap, win = case
            q, k, v, do = flash_inputs(b, hq, hkv, s, d, dt, gen)
            kw = dict(scale=d ** -0.5, softcap=cap, window=win)
            o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
            o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, **kw)
            grads = ops.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            again = ops.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                              **kw)
            torch.cuda.synchronize()
            line = []
            for name, got, ref, lim in (
                    [("O", o, o_ref, tol), ("lse", lse, lse_ref, LSE_TOL)]
                    + [(n, g, w, tol) for n, g, w in
                       zip(("dQ", "dK", "dV"), grads, want)]):
                err = (got.float() - ref.float()).abs().max().item()
                r = err / ref.float().abs().max().item()
                line.append(f"{name} {r:.2e}")
                if not r <= lim:
                    raise AssertionError(
                        f"flash {name} disagrees with its plain version at "
                        f"{case} {dt}: {r} of max |value| > {lim}")
                if (dt == torch.bfloat16 and case == FLASH_CASES[0]
                        and name != "lse"):
                    key = {"O": "flash_attention",
                           "dQ": "flash_attention_bwd_dq"}.get(
                               name, "flash_attention_bwd_dkv")
                    errs[key] = max(errs.get(key, 0.0), err)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"flash backward not bitwise "
                                     f"reproducible at {case} {dt}")
            log(f"[kernels] flash {str(dt)[6:]} (B,Hq,Hkv,S,D,cap,win)="
                f"{case}: err/max " + ", ".join(line)
                + f" (tol {tol}, lse {LSE_TOL}); backward bitwise equal "
                f"on a second run")
            del q, k, v, do, o, lse, o_ref, lse_ref, grads, again, want


def phase_exact(spec, registry, pex):
    """Full width in f32: Engine norms vs per-example plain backward."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    from repro_torch.kernels import ops

    cfg = spec.full(dtype="float32")
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec("exact", "train", EXACT_S, EXACT_B), rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    results = {}
    for flash in (False, True):
        c = with_flash(cfg) if flash else cfg
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results[flash] = pex.Engine(pex.PexSpec()).step(
            registry.make_loss_fn_v2(spec, c), params, batch,
            [pex.Norms(), pex.Grads()])
        torch.cuda.synchronize()
        n = ops.launch_counts()
        log(f"[exact] Engine.step([Norms, Grads]) f32 B={EXACT_B} "
            f"S={EXACT_S} flash={flash}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call); "
            f"launches {n}")
        want = cfg.n_layers if flash else 0
        if any(n[k] != want for k in FLASH_KERNELS):
            raise AssertionError(f"flash={flash}: flash launches {n}, "
                                 f"expected {want} of each")

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    p = tree_unflatten(treedef, leaves)
    oracle = []
    for j in range(EXACT_B):
        ex = {k: v[j:j + 1] for k, v in batch.items()}
        gs = torch.autograd.grad(loss_fn(p, ex, pex.NULL)[0][0], leaves)
        oracle.append(sum(torch.sum(torch.square(g.float())) for g in gs))
        del gs
    oracle = torch.stack(oracle)
    log(f"[exact] per-example sq norms: plain  {oracle.tolist()}")
    gs = torch.autograd.grad(loss_fn(p, batch, pex.NULL)[0].sum(), leaves)
    for flash, res in results.items():
        norms = res.sq_norms.sum(-1)
        r = rel_err(norms, oracle)
        log(f"[exact] flash={flash} per-example sq norms: engine "
            f"{norms.tolist()}")
        log(f"[exact] flash={flash} norms max rel err {r:.2e} (tol 1e-3: "
            f"f32, summation order of the kernels vs cuBLAS)")
        if not r < 1e-3:
            raise AssertionError(f"full-width norms disagree (flash="
                                 f"{flash}): {r}")
        worst = 0.0
        for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
            worst = max(worst, ((g_eng - g).norm() / g.norm()).item())
        log(f"[exact] flash={flash} summed grads vs plain batch backward: "
            f"max rel (Frobenius) err over {len(gs)} leaves {worst:.2e} "
            f"(tol 1e-4: f32)")
        if not worst < 1e-4:
            raise AssertionError(f"summed gradients disagree (flash="
                                 f"{flash}): {worst}")


def phase_main(spec, registry, pex, cfg, shape, tag, expected, kernels):
    """A DP-SGD path: three steps of ``cfg`` at ``shape`` = (B, S): the
    main path (phase 5), the flash path (phase 6) or the MoE path (phase
    8). ``kernels`` are the counted kernels the path must launch. Returns
    a dict of what the run read."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gram_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.nn import attention as attn_mod
    from repro_torch.optim import adamw

    b, s = shape
    flash = cfg.attn.flash
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init(params)
    noise_gen = torch.Generator(device="cuda").manual_seed(1)
    eng = pex.Engine(pex.PexSpec())
    want_fwd, want_norms, want_grads = pass_launches(expected, cfg)
    log(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, B={b} "
        f"S={s}; expected launches per step (pick_method at S={s}): forward "
        f"{want_fwd}; norms backward {want_norms}; reweighted backward "
        f"{want_grads}")
    batches = [registry.make_train_batch(
        spec, cfg, ShapeSpec(tag, "train", s, b), rng_seed=i)
        for i in range(STEPS)]

    # observe the real path: launches in the forward and per backward pass,
    # each kernel's device time from CUDA events around its launch
    # function, and the attention core's from events around it
    passes = []
    events = {k: [] for k in kernels}
    seg_calls = []        # per step: (seg_ids, n_seg, T, p_in, p_out, dtype)
    orig_grad = plan_mod._grad
    kfns = {"gram_norm": (gn, "gram_norm"),
            "direct_norm": (dn, "direct_norm"),
            "segmented_norm": (sn, "segmented_norm"),
            "flash_attention": (fa, "flash_attention_fwd"),
            "flash_attention_bwd_dq": (fa, "flash_attention_bwd_dq"),
            "flash_attention_bwd_dkv": (fa, "flash_attention_bwd_dkv")}
    kfns = {k: kfns[k] for k in kernels}
    orig_fns = {k: getattr(m, a) for k, (m, a) in kfns.items()}
    core_mod, core_name = ((ops, "flash_attention_vjp") if flash
                           else (attn_mod, "_attend"))
    orig_core = getattr(core_mod, core_name)
    attn = AttentionEvents(orig_core)

    def counted_grad(out, inputs, seed, **kw):
        before = ops.launch_counts()
        gs = orig_grad(out, inputs, seed, **kw)
        after = ops.launch_counts()
        passes.append((len(inputs), before,
                       {k: after[k] - before[k] for k in after}))
        return gs

    def timed(name):
        fn = orig_fns[name]

        def wrapper(*a, **kw):
            if name == "segmented_norm":
                h, z, seg_ids, n_seg = a
                seg_calls[-1].append((seg_ids, n_seg, h.shape[0], h.shape[1],
                                      z.shape[1], h.dtype))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return wrapper

    plan_mod._grad = counted_grad
    for k, (m, a) in kfns.items():
        setattr(m, a, timed(k))
    setattr(core_mod, core_name, attn)
    step_ms, kern_ms, attn_ms, losses = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launch_counts()
        for i, batch in enumerate(batches):
            passes.clear()
            attn.clear()
            seg_calls.append([])
            for v in events.values():
                v.clear()
            torch.cuda.synchronize()
            at_start = ops.launch_counts()
            t0 = time.perf_counter()
            res = eng.step(loss_fn, params, batch,
                           [pex.Norms(), pex.Clip(1.0),
                            pex.Noise(0.1, noise_gen), pex.GNS()])
            params, opt = adamw.update(opt_cfg, opt, params, res.grads)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            kern_ms.append({k: sum(a.elapsed_time(b) for a, b in v)
                            for k, v in events.items()})
            attn_ms.append(attn.ms())
            losses.append(res.loss.item())
            norms = res.sq_norms.sum(-1)
            cc = res.clip_coef
            log(f"[{tag}] step {i}: {step_ms[-1]:.1f} ms; loss "
                f"{losses[-1]:.4f}; sq norms {norms.tolist()}; clip "
                f"coef {cc.tolist()}; gns {res.gns.item():.4g}; kernel ms "
                f"{ {k: round(v, 3) for k, v in kern_ms[-1].items()} }; "
                f"attention core fwd/bwd ms {attn_ms[-1][0]:.3f}/"
                f"{attn_ms[-1][1]:.3f}; launches per backward "
                f"{[p[2] for p in passes]}")
            for name, t in (("loss", res.loss), ("norms", norms),
                            ("gns", res.gns)):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"step {i}: {name} not finite")
            if not bool(((cc > 0) & (cc <= 1)).all()):
                raise AssertionError(f"step {i}: clip coef outside (0, 1]")
            if len(passes) != 2:
                raise AssertionError(f"step {i}: {len(passes)} backward "
                                     f"passes, expected norms + reweighted")
            (n_in0, before0, norms_pass), (_, _, grads_pass) = passes
            fwd_pass = {k: before0[k] - at_start[k] for k in before0}
            if fwd_pass != want_fwd:
                raise AssertionError(f"step {i}: the tapped forward "
                                     f"launched {fwd_pass}, expected "
                                     f"{want_fwd}")
            if n_in0 != 1 or norms_pass != want_norms:
                raise AssertionError(f"step {i}: norms pass launched "
                                     f"{norms_pass}, expected {want_norms}")
            if grads_pass != want_grads:
                raise AssertionError(f"step {i}: the reweighted backward "
                                     f"launched {grads_pass}, expected "
                                     f"{want_grads}")
            del res
        launches = ops.launch_counts()
    finally:
        plan_mod._grad = orig_grad
        for k, (m, a) in kfns.items():
            setattr(m, a, orig_fns[k])
        setattr(core_mod, core_name, orig_core)
    per_step = {k: want_fwd[k] + want_norms[k] + want_grads[k]
                for k in launches}
    for k, n in launches.items():
        if n != STEPS * per_step[k] or (k in kernels and n == 0):
            raise AssertionError(f"{k}: {n} launches on the {tag} path, "
                                 f"expected {STEPS * per_step[k]}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] launches over {STEPS} steps: {launches}; every pass "
        f"launched what it should")
    log(f"[{tag}] peak memory {peak:.2f} GiB (since the phase began)")
    return {"launches": launches, "kern_ms": kern_ms, "step_ms": step_ms,
            "attn_ms": attn_ms, "losses": losses, "peak_gib": peak,
            "seg_calls": seg_calls}


def phase_moe_exact(spec, registry, pex):
    """phi3.5-moe at full width in f32: Engine norms against per-example
    gradients of the batched loss. Capacity dispatch couples the examples
    of a group (which tokens get a slot), so the oracle is example j's
    gradient of ONE batched forward with every other example present, not
    a forward of example j alone."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    cfg = dataclasses.replace(spec.full(dtype="float32"), n_layers=MOE_LAYERS)
    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec("moe-exact", "train", MOE_EXACT_S, MOE_EXACT_B),
        rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    kept = []             # (valid slots, n_seg) of each segmented launch
    launch = sn.segmented_norm

    def recorded(h, z, seg_ids, n_seg):
        kept.append((int(((seg_ids >= 0) & (seg_ids < n_seg)).sum()), n_seg))
        return launch(h, z, seg_ids, n_seg)

    sn.segmented_norm = recorded
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = pex.Engine(pex.PexSpec()).step(loss_fn, params, batch,
                                             [pex.Norms(), pex.Grads()])
        torch.cuda.synchronize()
        n = ops.launch_counts()
    finally:
        sn.segmented_norm = launch
    assignments = MOE_EXACT_B * MOE_EXACT_S * cfg.moe.top_k
    log(f"[moe-exact] Engine.step([Norms, Grads]) f32 {cfg.n_layers} layers "
        f"B={MOE_EXACT_B} S={MOE_EXACT_S}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call); launches "
        f"{n}; slots kept per segmented launch {[k for k, _ in kept]} of "
        f"{assignments} token-expert assignments "
        f"({assignments - min(k for k, _ in kept)} dropped at most), "
        f"{kept[0][1]} composite segments")
    if n["segmented_norm"] != 3 * cfg.n_layers:
        raise AssertionError(f"moe-exact: {n['segmented_norm']} segmented "
                             f"launches, expected {3 * cfg.n_layers}")

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    p = tree_unflatten(treedef, leaves)
    lv = loss_fn(p, batch, pex.NULL)[0]
    oracle = []
    for j in range(MOE_EXACT_B):
        gs = torch.autograd.grad(lv[j], leaves, retain_graph=True)
        oracle.append(sum(torch.sum(torch.square(g)) for g in gs))
        del gs
    oracle = torch.stack(oracle)
    gs = torch.autograd.grad(lv.sum(), leaves)
    norms = res.sq_norms.sum(-1)
    r = rel_err(norms, oracle)
    log(f"[moe-exact] per-example sq norms: oracle {oracle.tolist()}")
    log(f"[moe-exact] per-example sq norms: engine {norms.tolist()}")
    log(f"[moe-exact] norms max rel err {r:.2e} (tol 1e-3: f32, summation "
        f"order of the kernels vs cuBLAS)")
    if not r < 1e-3:
        raise AssertionError(f"phi3.5-moe norms disagree with the batched-"
                             f"graph oracle: {r}")
    worst = 0.0
    for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
        worst = max(worst, ((g_eng - g).norm() / g.norm()).item())
    log(f"[moe-exact] summed grads vs plain batch backward: max rel "
        f"(Frobenius) err over {len(gs)} leaves {worst:.2e} (tol 1e-4: f32)")
    if not worst < 1e-4:
        raise AssertionError(f"phi3.5-moe summed gradients disagree: {worst}")


def seg_inputs(t, p_in, p_out, dt, gen):
    import torch
    return (torch.randn(t, p_in, generator=gen, device="cuda").to(dt),
            torch.randn(t, p_out, generator=gen, device="cuda").to(dt))


def phase_seg_kernels(seg_calls, errs):
    """``segmented_norm`` against its plain version: at the MoE path's
    gate/up and down shapes with the segment ids of its first step
    (random inputs), and at the edge cases; each twice, for bitwise-equal
    results. Returns the two path cases for the table."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.segmented_norm import segmented_norm_ref

    first = {(pi, po): (seg, n_seg) for seg, n_seg, _, pi, po, _
             in reversed(seg_calls[0])}
    path = [(seg.shape[0], pi, po, seg, n_seg)
            for (pi, po), (seg, n_seg) in sorted(first.items())]
    gen = torch.Generator(device="cuda").manual_seed(5)

    def ids(t, n, drop):
        seg = torch.randint(0, n, (t,), generator=gen, device="cuda")
        off = torch.rand(t, generator=gen, device="cuda") < drop
        return torch.where(off, n + 3, seg)

    edge = [("ragged T and p_out", 777, 256, 333, ids(777, 20, 0.2), 20),
            ("all rows dropped", 500, 128, 64,
             torch.full((500,), 9, device="cuda"), 4),
            ("empty segments", 600, 200, 136, 2 * ids(600, 15, 0.1), 30),
            ("one segment", 3000, 512, 384,
             torch.zeros(3000, dtype=torch.long, device="cuda"), 1)]
    cases = [(f"path {pi}->{po}", t, pi, po, seg, n)
             for t, pi, po, seg, n in path] + edge
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[str(dt)]
        for name, t, pi, po, seg, n in cases:
            h, z = seg_inputs(t, pi, po, dt, gen)
            got = ops.segmented_norm(h, z, seg, n)
            again = ops.segmented_norm(h, z, seg, n)
            want = segmented_norm_ref(h, z, seg, n)
            torch.cuda.synchronize()
            full = want > 0
            r = rel_err(got[full], want[full]) if bool(full.any()) else 0.0
            if not (r <= tol and bool((got[~full] == 0).all())):
                raise AssertionError(
                    f"segmented_norm disagrees with its plain version at "
                    f"{name} (T={t}, {pi}->{po}, {n} segments) {dt}: rel err "
                    f"{r} > {tol}, or an empty segment is not 0")
            if not torch.equal(got, again):
                raise AssertionError(f"segmented_norm not bitwise "
                                     f"reproducible at {name} {dt}")
            if dt == torch.bfloat16 and name.startswith("path"):
                errs["segmented_norm"] = max(
                    errs.get("segmented_norm", 0.0),
                    (got - want).abs().max().item())
            log(f"[segmented] {str(dt)[6:]} {name}: T={t} {pi}->{po}, {n} "
                f"segments ({int(full.sum())} non-empty, "
                f"{int(((seg >= 0) & (seg < n)).sum())} rows kept): rel "
                f"{r:.2e} (tol {tol}); empty segments 0; bitwise equal on a "
                f"second run")
            del h, z
    return path


def seg_bound_ms(calls):
    """The least time the card could take for the segmented launches of one
    step: per launch, the larger of the bytes the function must move (the
    kept rows of h and z̄, the ids, the output) over the HBM rate and the
    fewest operations it needs on this data (per segment, the gram or the
    direct form, ``ops.segmented_flop_estimate``) over the peak for its
    type. Also returns the kernel's own operations (the direct form) over
    the least, summed over the launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    total, by, done, least = 0.0, {}, 0.0, 0.0
    for seg, n_seg, t, pi, po, dt in calls:
        item = 2 if str(dt) == "torch.bfloat16" else 4
        t_bytes = sn.bytes_estimate(seg, n_seg, pi, po, item) \
            / PEAK_BYTES_PER_S * 1e3
        flops = ops.segmented_flop_estimate(seg, n_seg, pi, po)
        t_ops = flops / PEAK_FLOPS[str(dt)] * 1e3
        total += max(t_bytes, t_ops)
        key = "bytes" if t_bytes >= t_ops else "operations"
        by[key] = by.get(key, 0.0) + max(t_bytes, t_ops)
        done += sn.flop_estimate(seg, n_seg, pi, po)
        least += flops
    return total, max(by, key=by.get), done / least


def seg_table(path, errs, run):
    """The segmented kernel's row: its time per MoE step (events), the plain
    version's and the bound from this run's launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.segmented_norm import segmented_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = torch.bfloat16
    per_step = {}        # (p_in, p_out) → launches per step
    for _, _, _, pi, po, _ in run["seg_calls"][0]:
        per_step[(pi, po)] = per_step.get((pi, po), 0) + 1
    plain_ms = 0.0
    for t, pi, po, seg, n in path:
        h, z = seg_inputs(t, pi, po, dt, gen)
        ms = time_ms(lambda: ops.segmented_norm(h, z, seg, n), 10)
        p_ms = time_ms(lambda: segmented_norm_ref(h, z, seg, n), 1)
        b_ms, by, extra = seg_bound_ms([(seg, n, t, pi, po, dt)])
        log(f"[table] segmented_norm bf16 T={t} {pi}->{po}, {n} segments "
            f"x{per_step[(pi, po)]}/step: kernel {ms:.3f} ms, plain "
            f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / ms:.2%} of "
            f"bound; the kernel's direct form does {extra:.1f}x the fewest "
            f"operations the function needs here")
        plain_ms += per_step[(pi, po)] * p_ms
        del h, z
    steady = run["seg_calls"][1:] or run["seg_calls"][:1]
    bounds = [seg_bound_ms(c) for c in steady]
    kms = [m["segmented_norm"] for m in run["kern_ms"][1:]] \
        or [run["kern_ms"][0]["segmented_norm"]]
    ms = sum(kms) / len(kms)
    bound = sum(b for b, _, _ in bounds) / len(bounds)
    log(f"[table] segmented_norm on the MoE path: {ms:.3f} ms per steady "
        f"step (events), bound {bound:.4f} ms per step from its launches' "
        f"segments and kept rows ({bounds[0][1]}), {bound / ms:.2%} of "
        f"bound; the kernel's direct form does "
        f"{bounds[0][2]:.1f}x the fewest operations")
    return {"name": "segmented_norm", "route": "cuda",
            "source": SOURCES["segmented_norm"][0],
            "replaces": SOURCES["segmented_norm"][1],
            "launches": run["launches"]["segmented_norm"],
            "max_abs_err": errs["segmented_norm"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bounds[0][1], "library_ms": None,
            "per": f"phi3.5-moe step, {MOE_LAYERS} layers, B={MOE_B} "
                   f"S={MOE_S} bf16"}


def phase_table(expected, errs, launches, kern_ms):
    """Per-shape kernel and plain times and the bound; JSON rows with the
    main path's per-step totals."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.direct_norm import direct_norm_ref
    from repro_torch.kernels.ref import gram_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    kern = {"gram_norm": (ops.gram_norm, gram_norm_ref),
            "direct_norm": (ops.direct_norm, direct_norm_ref)}
    rows = []
    for name, shapes in expected.items():
        run, plain = kern[name]
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        bound_by = {}
        for (pi, po), n in sorted(shapes.items()):
            h = torch.randn(B, S, pi, generator=gen, device="cuda").to(dt)
            z = torch.randn(B, S, po, generator=gen, device="cuda").to(dt)
            reps = 3 if po > 10 * pi else 20
            ms = time_ms(lambda: run(h, z), reps)
            plain_ms = time_ms(lambda: plain(h, z), max(1, reps // 3))
            nbytes = (h.numel() + z.numel()) * h.element_size() + B * 4
            flops = ops.flop_estimate(B, S, pi, po)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[str(dt)] * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            bound_by[by] = bound_by.get(by, 0.0) + n * bound
            log(f"[table] {name} bf16 ({B},{S},{pi})x({B},{S},{po}) x{n}/step:"
                f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound:.4f} ms ({by}: {flops:.3g} flops, {nbytes:.3g} B), "
                f"{bound / ms:.1%} of bound")
            if name == "direct_norm":
                gram_ms = time_ms(lambda: ops.gram_norm(h, z), reps)
                log(f"[table] gram_norm at the same shape (the route the "
                    f"main path does not take here): {gram_ms:.3f} ms, "
                    f"{bound / gram_ms:.1%} of bound")
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain_ms
            tot["bound_ms"] += n * bound
            del h, z
        steady = [k[name] for k in kern_ms[1:]] or [kern_ms[0][name]]
        log(f"[table] {name}: per step {tot['ms']:.2f} ms by shape, "
            f"{sum(steady) / len(steady):.2f} ms on the main path (events)")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": sum(steady) / len(steady),
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": max(bound_by, key=bound_by.get),
            "library_ms": None, "per": "main-path step, B=8 S=512 bf16"})
    return rows


def flash_table(errs, launches, kern_ms):
    """The flash kernels at the main path's shape (bf16): per-launch kernel,
    plain and library times and the bound, scaled to the flash path's
    launches per step; JSON rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = torch.bfloat16
    b, hq, hkv, s, d = FLASH_CASES[0][:5]
    scale = d ** -0.5
    q, k, v, do = flash_inputs(b, hq, hkv, s, d, dt, gen)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale)
    delta = fa.row_delta(o, do)
    args = (q, k, v, do, lse, delta)
    run = {"flash_attention": (
               lambda: fa.flash_attention_fwd(q, k, v, scale=scale),
               lambda: fa.flash_attention_fwd_ref(q, k, v, scale=scale)),
           "flash_attention_bwd_dq": (
               lambda: fa.flash_attention_bwd_dq(*args, scale=scale),
               lambda: fa.flash_attention_bwd_dq_ref(*args, scale=scale)),
           "flash_attention_bwd_dkv": (
               lambda: fa.flash_attention_bwd_dkv(*args, scale=scale),
               lambda: fa.flash_attention_bwd_dkv_ref(*args, scale=scale))}
    kinds = {"flash_attention": "fwd", "flash_attention_bwd_dq": "dq",
             "flash_attention_bwd_dkv": "dkv"}

    # the yardstick: one PyTorch call for the same attention, forward and
    # its autograd backward (dQ, dK and dV together); never on the path
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        ql, kl, vl, is_causal=True, scale=scale, enable_gqa=True)
    out = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out, (ql, kl, vl), do, retain_graph=True)
    lib_ms = {"flash_attention": time_ms(sdpa, 20),
              "bwd": time_ms(sdpa_bwd, 20)}
    log(f"[table] scaled_dot_product_attention bf16 at the main shape "
        f"(yardstick, never on the path): forward "
        f"{lib_ms['flash_attention']:.4f} ms, autograd backward "
        f"{lib_ms['bwd']:.4f} ms per call")

    rows = []
    for name, (kern, plain) in run.items():
        kind = kinds[name]
        n = launches[name] // STEPS
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        flops = fa.flop_estimate(kind, b, hq, s, s, d)
        nbytes = fa.byte_estimate(kind, b, hq, hkv, s, s, d, 2)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(dt)] * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        lib = lib_ms.get(name, lib_ms["bwd"])
        steady = [m[name] for m in kern_ms[1:]] or [kern_ms[0][name]]
        log(f"[table] {name} bf16 (B,Hq,Hkv,S,D)=({b},{hq},{hkv},{s},{d}) "
            f"x{n}/step: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{flops:.3g} flops, {nbytes:.3g} B), {bound / ms:.1%} of bound;"
            f" on the flash path {sum(steady) / len(steady):.3f} ms per "
            f"step (events)")
        row = {"name": name, "route": "cuda", "source": SOURCES[name][0],
               "replaces": SOURCES[name][1], "launches": launches[name],
               "max_abs_err": errs[name],
               "ms": sum(steady) / len(steady), "plain_ms": n * plain_ms,
               "bound_ms": n * bound, "bound_by": by,
               "library_ms": n * lib,
               "per": "flash-path step, B=8 S=512 bf16"}
        if kind != "fwd":
            row["library_note"] = ("scaled_dot_product_attention's autograd "
                                   "backward, which forms dQ, dK and dV in "
                                   "one call")
        rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import pex
    from repro_torch.models import registry

    name, smi = phase_device()
    phase_build()
    spec = registry.get("llama3.2-1b")
    cfg = spec.full()
    errs = {}
    phase_kernels(cfg, errs)
    phase_flash_kernels(errs)
    phase_exact(spec, registry, pex)
    torch.cuda.empty_cache()
    expected = main_path_launches(cfg, S)
    main_run = phase_main(spec, registry, pex, cfg, (B, S), "main",
                          expected, NORM_KERNELS)
    torch.cuda.empty_cache()
    flash_run = phase_main(spec, registry, pex, with_flash(cfg), (B, S),
                           "flash", expected, NORM_KERNELS + FLASH_KERNELS)
    torch.cuda.empty_cache()
    d_loss = abs(flash_run["losses"][0] - main_run["losses"][0]) \
        / abs(main_run["losses"][0])
    log(f"[flash] step-0 loss {flash_run['losses'][0]:.6f} vs unfused "
        f"{main_run['losses'][0]:.6f}: rel diff {d_loss:.2e} (tol "
        f"{LOSS_TOL}: same params and batch, only the attention route "
        f"differs)")
    if not d_loss <= LOSS_TOL:
        raise AssertionError(f"flash and unfused step-0 losses differ by "
                             f"{d_loss}")
    for tag, r in (("main (unfused)", main_run), ("flash", flash_run)):
        steady = r["step_ms"][1:]
        fl = [sum(m[k] for k in FLASH_KERNELS if k in m)
              for m in r["kern_ms"][1:]]
        log(f"[compare] {tag}: steady step ms {steady}; attention core "
            f"fwd+bwd ms per steady step "
            f"{[round(a + b, 3) for a, b in r['attn_ms'][1:]]}; flash "
            f"kernel ms per steady step {[round(x, 3) for x in fl]}; peak "
            f"memory {r['peak_gib']:.2f} GiB")
    moe_spec = registry.get("phi3.5-moe")
    phase_moe_exact(moe_spec, registry, pex)
    torch.cuda.empty_cache()
    moe_cfg = dataclasses.replace(moe_spec.full(), n_layers=MOE_LAYERS)
    moe_run = phase_main(moe_spec, registry, pex, moe_cfg, (MOE_B, MOE_S),
                         "moe", main_path_launches(moe_cfg, MOE_S),
                         NORM_KERNELS + ("segmented_norm",))
    torch.cuda.empty_cache()
    log(f"[compare] moe: steady step ms {moe_run['step_ms'][1:]}; segmented "
        f"kernel ms per steady step "
        f"{[round(m['segmented_norm'], 3) for m in moe_run['kern_ms'][1:]]};"
        f" attention core fwd+bwd ms per steady step "
        f"{[round(a + b, 3) for a, b in moe_run['attn_ms'][1:]]}; peak "
        f"memory {moe_run['peak_gib']:.2f} GiB")
    path = phase_seg_kernels(moe_run["seg_calls"], errs)
    rows = phase_table(expected, errs, main_run["launches"],
                       main_run["kern_ms"])
    rows.append(seg_table(path, errs, moe_run))
    rows += flash_table(errs, flash_run["launches"], flash_run["kern_ms"])
    log(f"[table] kernels: {', '.join(r['name'] for r in rows)}; main step "
        f"ms {main_run['step_ms']}; flash step ms {flash_run['step_ms']}; "
        f"moe step ms {moe_run['step_ms']}")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
