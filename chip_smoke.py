#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) if it fails:

1. device   — the card's name, and its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build    — compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels  — ``gram_norm`` (triangular and full grid) and ``direct_norm``
              against their plain PyTorch versions in f32 and bf16 at the
              main path's shapes, a ragged shape and the LM head;
4. exact    — llama3.2-1b at full width in f32: ``Engine.step([Norms(),
              Grads()])`` against a per-example loop of plain backward
              passes, and its summed gradient against a plain batch
              backward;
5. main     — the main path: llama3.2-1b at full width in bf16, B=8,
              S=512, three DP-SGD steps ``[Norms, Clip, Noise, GNS]`` each
              followed by an AdamW update, with the kernel launches of each
              backward pass counted;
6. table    — each kernel's time, plain time and bound at the main path's
              shapes, and the gram kernel at the direct kernel's shapes
              (the LM head's, where the forced direct route is not the
              cheaper one, and wk/wv's).

Every kernel is called through its ``repro_torch.kernels.ops`` wrapper,
the one the main path goes through. A kernel's bound is the least time the
card could take for the function, whichever route computes it: the input
bytes over the HBM rate or the fewer operations of the two routes
(``ops.flop_estimate``) over the bf16 tensor-core peak, whichever is
longer.

TF32 is off for matmuls and cuDNN throughout, so the f32 plain versions
are full f32. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the kernel table as
JSON, and the line before that the ``nvidia-smi`` reading.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S = 8, 512            # main path batch and sequence length
EXACT_B, EXACT_S = 4, 256
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
SOURCES = {"gram_norm": ("src/repro_torch/csrc/gram_norm.cu",
                         "src/repro/kernels/gram_norm.py:297"),
           "direct_norm": ("src/repro_torch/csrc/direct_norm.cu",
                           "src/repro/kernels/direct_norm.py:141")}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want):
    return ((got - want).abs() / want.abs()).max().item()


def layer_shapes(cfg):
    """(p_in, p_out) of every tapped dense layer of one block."""
    a = cfg.attn
    d, f = cfg.d_model, cfg.mlp.d_ff
    hq, hkv = a.n_heads_p * a.head_dim, a.n_kv * a.head_dim
    return [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, f), (d, f), (f, d)]


def main_path_launches(cfg, s):
    """{kernel: {(p_in, p_out): launches per step}} from the port's own
    dispatch: each block's dense layers by ``pick_method``, the head
    forced to direct (``nn/embedding.lm_head``)."""
    from repro_torch.core.norms import pick_method
    out = {"gram_norm": {}, "direct_norm": {}}
    for pi, po in layer_shapes(cfg):
        k = pick_method(s, pi, po) + "_norm"
        out[k][(pi, po)] = out[k].get((pi, po), 0) + cfg.n_layers
    out["direct_norm"][(cfg.d_model, cfg.vocab)] = 1
    return out


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


def phase_exact(spec, registry, pex):
    """Full width in f32: Engine norms vs per-example plain backward."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    cfg = spec.full(dtype="float32")
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec("exact", "train", EXACT_S, EXACT_B), rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    t0 = time.perf_counter()
    res = pex.Engine(pex.PexSpec()).step(loss_fn, params, batch,
                                         [pex.Norms(), pex.Grads()])
    torch.cuda.synchronize()
    log(f"[exact] Engine.step([Norms, Grads]) f32 B={EXACT_B} S={EXACT_S}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call)")
    norms = res.sq_norms.sum(-1)

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
    r = rel_err(norms, oracle)
    log(f"[exact] per-example sq norms: engine {norms.tolist()}")
    log(f"[exact] per-example sq norms: plain  {oracle.tolist()}")
    log(f"[exact] norms max rel err {r:.2e} (tol 1e-3: f32, summation "
        f"order of the kernels vs cuBLAS)")
    if not r < 1e-3:
        raise AssertionError(f"full-width norms disagree: {r}")

    gs = torch.autograd.grad(loss_fn(p, batch, pex.NULL)[0].sum(), leaves)
    worst = 0.0
    for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
        worst = max(worst, ((g_eng - g).norm() / g.norm()).item())
    log(f"[exact] summed grads vs plain batch backward: max rel "
        f"(Frobenius) err over {len(gs)} leaves {worst:.2e} (tol 1e-4: f32)")
    if not worst < 1e-4:
        raise AssertionError(f"summed gradients disagree: {worst}")


def phase_main(spec, registry, pex, expected):
    """The main path; returns (launches, per-step kernel ms, step ms)."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import gram_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw

    cfg = spec.full(dtype="bfloat16")
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init(params)
    noise_gen = torch.Generator(device="cuda").manual_seed(1)
    eng = pex.Engine(pex.PexSpec())
    per_step = {k: sum(v.values()) for k, v in expected.items()}
    log(f"[main] expected launches per step from pick_method at S={S}: "
        f"{per_step}")
    batches = [registry.make_train_batch(
        spec, cfg, ShapeSpec("main", "train", S, B), rng_seed=i)
        for i in range(STEPS)]

    # observe the real main path: launches per backward pass, and each
    # kernel's device time from CUDA events around its launch function
    passes = []
    events = {k: [] for k in expected}
    orig_grad = plan_mod._grad
    kmods = {"gram_norm": gn, "direct_norm": dn}
    orig_fns = {k: getattr(m, k) for k, m in kmods.items()}

    def counted_grad(out, inputs, seed, **kw):
        before = ops.launch_counts()
        gs = orig_grad(out, inputs, seed, **kw)
        after = ops.launch_counts()
        passes.append((len(inputs), {k: after[k] - before[k] for k in after}))
        return gs

    def timed(name):
        fn = orig_fns[name]

        def wrapper(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return wrapper

    plan_mod._grad = counted_grad
    for k, m in kmods.items():
        setattr(m, k, timed(k))
    step_ms, kern_ms = [], []
    try:
        ops.reset_launch_counts()
        for i, batch in enumerate(batches):
            passes.clear()
            for v in events.values():
                v.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.step(loss_fn, params, batch,
                           [pex.Norms(), pex.Clip(1.0),
                            pex.Noise(0.1, noise_gen), pex.GNS()])
            params, opt = adamw.update(opt_cfg, opt, params, res.grads)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            kern_ms.append({k: sum(a.elapsed_time(b) for a, b in v)
                            for k, v in events.items()})
            norms = res.sq_norms.sum(-1)
            cc = res.clip_coef
            log(f"[main] step {i}: {step_ms[-1]:.1f} ms; loss "
                f"{res.loss.item():.4f}; sq norms {norms.tolist()}; clip "
                f"coef {cc.tolist()}; gns {res.gns.item():.4g}; kernel ms "
                f"{ {k: round(v, 3) for k, v in kern_ms[-1].items()} }; "
                f"launches per backward {passes}")
            for name, t in (("loss", res.loss), ("norms", norms),
                            ("gns", res.gns)):
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"step {i}: {name} not finite")
            if not bool(((cc > 0) & (cc <= 1)).all()):
                raise AssertionError(f"step {i}: clip coef outside (0, 1]")
            if len(passes) != 2:
                raise AssertionError(f"step {i}: {len(passes)} backward "
                                     f"passes, expected norms + reweighted")
            (n_in0, norms_pass), (_, grads_pass) = passes
            if n_in0 != 1 or norms_pass != per_step:
                raise AssertionError(f"step {i}: norms pass launched "
                                     f"{norms_pass}, expected {per_step}")
            if any(grads_pass.values()):
                raise AssertionError(f"step {i}: the reweighted backward "
                                     f"launched norm kernels {grads_pass}")
        launches = ops.launch_counts()
    finally:
        plan_mod._grad = orig_grad
        for k, m in kmods.items():
            setattr(m, k, orig_fns[k])
    for k, n in launches.items():
        if n != STEPS * per_step[k] or n == 0:
            raise AssertionError(f"{k}: {n} launches on the main path, "
                                 f"expected {STEPS * per_step[k]}")
    log(f"[main] launches over {STEPS} steps: {launches}; "
        f"reweighted backward launched none")
    log(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB")
    return launches, kern_ms, step_ms


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
    phase_exact(spec, registry, pex)
    torch.cuda.empty_cache()
    expected = main_path_launches(cfg, S)
    launches, kern_ms, step_ms = phase_main(spec, registry, pex, expected)
    torch.cuda.empty_cache()
    rows = phase_table(expected, errs, launches, kern_ms)
    log(f"[table] kernels: gram_norm, direct_norm; step ms {step_ms}")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
