"""The port's decode state, unit by unit, against the JAX reference's.

On the reference's ``init`` parameters and the same numpy inputs, in f32 at
1e-5: ``_attend`` with a query offset and a cache's valid length over a
longer buffer (causal, windowed on local and global layers, softcapped);
one KV-cache write and attend (GQA, M-RoPE's text-only fallback, the
window, a precomputed cross cache); MLA's latent cache write and absorbed
form; RWKV's time and channel mix from a carried state and the state they
leave; the SSM's conv history and ``ssm`` from a carried state. Each cache
starts with rows already written, and the rows the call writes, the rows
it keeps and the state it leaves are held too. Then every family's cache
initialisers against the reference's shapes and dtypes, and ``interop``'s
cache carrying both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pex as jpex
from repro.configs.common import ShapeSpec as JShape
from repro.models import registry as jreg
from repro.nn import attention as jattn
from repro.nn import mla as jmla
from repro.nn import rwkv as jrwkv
from repro.nn import ssm as jssm
from repro.nn.param import unbox
from repro_torch import interop, pex
from repro_torch.configs.common import ShapeSpec
from repro_torch.models import registry
from repro_torch.nn import attention as tattn
from repro_torch.nn import mla as tmla
from repro_torch.nn import rwkv as trwkv
from repro_torch.nn import ssm as tssm

RTOL = 1e-5
B, T = 2, 12          # slots, cache rows


def close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def both(rng, shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def carry(jp):
    """The reference's unit parameters carried into the port."""
    return interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")


def cache_pair(rng, shapes):
    """A cache with every row drawn (rows past the write are never read),
    as the reference's dict and the port's."""
    j, t = {}, {}
    for k, shape in shapes.items():
        j[k], t[k] = both(rng, shape)
    return j, t


def held(port_cache, ref_cache):
    for k in ref_cache:
        close(port_cache[k], ref_cache[k])


# --- attention --------------------------------------------------------------

ATTEND_CASES = {"causal": {}, "window": dict(window=3),
                "softcap": dict(softcap=5.0), "gemma": dict(window=3,
                                                            softcap=5.0)}


@pytest.mark.parametrize("local_flag", [None, True, False])
@pytest.mark.parametrize("case", ATTEND_CASES)
def test_attend_with_offset_and_kv_len_matches(case, local_flag):
    """s = 3 queries at positions 5–7 over a 12-row buffer of which 8 are
    valid, 4 q heads on 2 kv heads."""
    kw = dict(d_model=16, n_heads=4, n_kv=2, head_dim=8, head_multiple=1,
              **ATTEND_CASES[case])
    jcfg, cfg = jattn.AttnCfg(**kw), tattn.AttnCfg(**kw)
    rng = np.random.default_rng(0)
    jq, tq = both(rng, (B, 3, 4, 8))
    jk, tk = both(rng, (B, T, 2, 8))
    jv, tv = both(rng, (B, T, 2, 8))
    flag = None if local_flag is None else jnp.array(local_flag)
    want = jattn._attend(jq, jk, jv, jcfg, 5, 8, flag)
    got = tattn._attend(tq, tk, tv, cfg, local_flag, q_offset=5, kv_len=8)
    close(got, want)


def _attn_pair(seed, **kw):
    jcfg, cfg = jattn.AttnCfg(**kw), tattn.AttnCfg(**kw)
    jp = unbox(jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                    dtype=jnp.float32))
    return jcfg, cfg, jp, carry(jp)


ATTN_CASES = {
    "gqa": dict(d_model=32, n_heads=4, n_kv=2, head_dim=8, head_multiple=1),
    "bias_padded_heads": dict(d_model=32, n_heads=3, n_kv=1, head_dim=8,
                              head_multiple=2, bias=True),
    "window_local": dict(d_model=32, n_heads=4, n_kv=2, head_dim=8,
                         head_multiple=1, window=3, softcap=5.0),
    "mrope_text": dict(d_model=32, n_heads=2, n_kv=2, head_dim=16,
                       head_multiple=1, mrope_sections=(2, 3, 3)),
    "partial_rope": dict(d_model=32, n_heads=4, n_kv=4, head_dim=8,
                         head_multiple=1, rope_dim=4),
}


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_kv_cache_write_and_attend_matches(case, s):
    """``attention(cache=, cache_index=5)`` on s new tokens (the default
    positions; M-RoPE broadcasts them to its three streams): the output,
    and the cache written in place at rows [5, 5+s) and kept elsewhere."""
    jcfg, cfg, jp, tp = _attn_pair(1, **ATTN_CASES[case])
    rng = np.random.default_rng(2)
    jx, tx = both(rng, (B, s, 32))
    shape = (B, T, cfg.n_kv, cfg.head_dim)
    jc, tc = cache_pair(rng, {"k": shape, "v": shape})
    before = {k: v.clone() for k, v in tc.items()}
    local = True if cfg.window is not None else None
    want, jnew = jax.jit(lambda p, x, c: jattn.attention(
        p, x, tap=jpex.NULL, cfg=jcfg, cache=c, cache_index=5,
        local_flag=None if local is None else jnp.array(local)))(jp, jx, jc)
    got = tattn.attention(tp, tx, tap=pex.NULL, cfg=cfg, cache=tc,
                          cache_index=5, local_flag=local)
    close(got, want)
    held(tc, jnew)
    for k in tc:
        assert torch.equal(tc[k][:, :5], before[k][:, :5])
        assert torch.equal(tc[k][:, 5 + s:], before[k][:, 5 + s:])


def test_cross_cache_attend_matches():
    """A cross-attention layer on a precomputed K/V cache (seamless's
    decode): no RoPE, no mask, ``memory`` not projected."""
    kw = dict(d_model=32, n_heads=4, n_kv=4, head_dim=8, head_multiple=1,
              cross=True)
    jcfg, cfg, jp, tp = _attn_pair(3, **kw)
    rng = np.random.default_rng(4)
    jx, tx = both(rng, (B, 2, 32))
    jm, tm = both(rng, (B, 7, 32))
    jc, tc = cache_pair(rng, {"k": (B, 7, 4, 8), "v": (B, 7, 4, 8)})
    want, _ = jattn.attention(jp, jx, tap=jpex.NULL, cfg=jcfg, memory=jm,
                              cache=jc)
    close(tattn.attention(tp, tx, tap=pex.NULL, cfg=cfg, memory=tm,
                          cache=tc), want)
    close(tattn.attention(tp, tx, tap=pex.NULL, cfg=cfg, cache=tc), want)


def test_init_kv_cache_matches():
    kw = dict(d_model=32, n_heads=4, n_kv=2, head_dim=8)
    want = jattn.init_kv_cache(3, T, jattn.AttnCfg(**kw), dtype=jnp.bfloat16)
    got = tattn.init_kv_cache(3, T, tattn.AttnCfg(**kw),
                              dtype=torch.bfloat16, device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16 and not got[k].any()


# --- MLA ----------------------------------------------------------------------

def _mla_pair():
    kw = dict(d_model=32, n_heads=4, q_lora=16, kv_lora=12, qk_nope=8,
              qk_rope=4, v_dim=6)
    jcfg, cfg = jmla.MlaCfg(**kw), tmla.MlaCfg(**kw)
    jp = unbox(jmla.init_mla(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32))
    return jcfg, cfg, jp, carry(jp)


@pytest.mark.parametrize("s", [1, 4])
def test_mla_latent_cache_absorbed_form_matches(s):
    """Prefill (s = 4) or decode (s = 1) at cache_index 6 in the absorbed
    form: the output, the latent and rope-key rows written in place."""
    jcfg, cfg, jp, tp = _mla_pair()
    rng = np.random.default_rng(6)
    jx, tx = both(rng, (B, s, 32))
    jc, tc = cache_pair(rng, {"ckv": (B, T, cfg.kv_lora),
                              "krope": (B, T, cfg.qk_rope)})
    want, jnew = jax.jit(lambda p, x, c: jmla.mla_attention(
        p, x, tap=jpex.NULL, cfg=jcfg, cache=c, cache_index=6))(jp, jx, jc)
    got = tmla.mla_attention(tp, tx, tap=pex.NULL, cfg=cfg, cache=tc,
                             cache_index=6)
    close(got, want)
    held(tc, jnew)


def test_mla_absorbed_equals_expanded_on_a_fresh_cache():
    """The absorbed form over a zero cache filled by the call is the
    expanded form (the function, in another order) at 1e-5."""
    _, cfg, _, tp = _mla_pair()
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(B, 5, 32)).astype(np.float32))
    cache = tmla.init_mla_cache(B, T, cfg, dtype=torch.float32, device="cpu")
    absorbed = tmla.mla_attention(tp, x, tap=pex.NULL, cfg=cfg, cache=cache,
                                  cache_index=0)
    expanded = tmla.mla_attention(tp, x, tap=pex.NULL, cfg=cfg)
    close(absorbed, expanded.numpy())


def test_init_mla_cache_matches():
    jcfg, cfg, _, _ = _mla_pair()
    want = jmla.init_mla_cache(3, T, jcfg, dtype=jnp.float32)
    got = tmla.init_mla_cache(3, T, cfg, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}


# --- RWKV ---------------------------------------------------------------------

def _rwkv_pair(init, seed):
    jcfg = jreg.get("rwkv6-3b").smoke().rwkv_cfg
    cfg = registry.get("rwkv6-3b").smoke().rwkv_cfg
    jp = unbox(init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    jp["mu"] = jnp.asarray(rng.normal(size=jp["mu"].shape) * 0.5,
                           jnp.float32)
    if "w0" in jp:      # away from the constant inits, so that every term binds
        jp["w0"] = jnp.asarray(rng.normal(-1.0, 0.5, jp["w0"].shape),
                               jnp.float32)
        jp["u"] = jnp.asarray(rng.normal(size=jp["u"].shape) * 0.5,
                              jnp.float32)
    return jcfg, cfg, jp, carry(jp)


def _rwkv_state(rng, cfg):
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return cache_pair(rng, {"tm_shift": (B, d), "cm_shift": (B, d),
                            "wkv": (B, nh, hd, hd)})


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("part", ["tmix", "cmix"])
def test_rwkv_state_step_matches(part, s):
    """``rwkv_tmix`` / ``rwkv_cmix`` from a drawn state: the output and
    the state left (the token-shift row and the final wkv matrix)."""
    init, jfn, tfn = {"tmix": (jrwkv.init_rwkv_tmix, jrwkv.rwkv_tmix,
                               trwkv.rwkv_tmix),
                      "cmix": (jrwkv.init_rwkv_cmix, jrwkv.rwkv_cmix,
                               trwkv.rwkv_cmix)}[part]
    jcfg, cfg, jp, tp = _rwkv_pair(init, 8)
    rng = np.random.default_rng(9)
    jx, tx = both(rng, (B, s, cfg.d_model))
    jst, tst = _rwkv_state(rng, cfg)
    want, jnew = jax.jit(lambda p, x, st: jfn(p, x, tap=jpex.NULL, cfg=jcfg,
                                              state=st))(jp, jx, jst)
    got = tfn(tp, tx, tap=pex.NULL, cfg=cfg, state=tst)
    close(got, want)
    held(tst, jnew)


def test_token_shift_from_previous_row_matches():
    rng = np.random.default_rng(10)
    jx, tx = both(rng, (B, 4, 8))
    jprev, tprev = both(rng, (B, 8))
    np.testing.assert_array_equal(
        trwkv._token_shift(tx, tprev).numpy(),
        np.asarray(jrwkv._token_shift(jx, jprev)))


def test_wkv_from_state_is_the_loop_continued():
    """Two segments through ``wkv_from`` give the one-shot loop's outputs
    bit for bit."""
    rng = np.random.default_rng(11)
    r, k, v = (torch.from_numpy(rng.normal(size=(2, 7, 3, 4))).float()
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 7, 3, 4))).float()
    u = torch.from_numpy(rng.normal(size=(3, 4))).float()
    whole = trwkv.wkv_loop(r, k, v, w, u)
    o1, st = trwkv.wkv_from(r[:, :3], k[:, :3], v[:, :3], w[:, :3], u,
                            torch.zeros(2, 3, 4, 4))
    o2, _ = trwkv.wkv_from(r[:, 3:], k[:, 3:], v[:, 3:], w[:, 3:], u, st)
    assert torch.equal(torch.cat([o1, o2], 1), whole)


def test_init_rwkv_state_matches():
    jcfg = jreg.get("rwkv6-3b").smoke().rwkv_cfg
    cfg = registry.get("rwkv6-3b").smoke().rwkv_cfg
    want = jrwkv.init_rwkv_state(3, jcfg, dtype=jnp.bfloat16)
    got = trwkv.init_rwkv_state(3, cfg, dtype=torch.bfloat16, device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


# --- SSM ----------------------------------------------------------------------

def _ssm_pair():
    jcfg = jreg.get("zamba2-7b").smoke().ssm
    cfg = registry.get("zamba2-7b").smoke().ssm
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = unbox(jssm.init_ssm(jax.random.PRNGKey(12), jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(12)
    jp["conv_b"] = jnp.asarray(rng.normal(size=jp["conv_b"].shape) * 0.1,
                               jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.normal(size=jp["dt_bias"].shape) * 0.5,
                                jnp.float32)
    return jcfg, cfg, jp, carry(jp)


@pytest.mark.parametrize("s", [1, 2, 6])
def test_causal_conv_history_matches(s):
    """The conv over a drawn (B, K-1, C) history, and the history it
    leaves: for s < K-1 part of the old one."""
    rng = np.random.default_rng(13)
    jx, tx = both(rng, (B, s, 10))
    jw, tw = both(rng, (4, 10))
    jb, tb = both(rng, (10,))
    jst, tst = both(rng, (B, 3, 10))
    want, jtail = jssm._causal_conv(jx, jw, jb, jst)
    got, tail = tssm._causal_conv(tx, tw, tb, tst)
    close(got, want)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("s", [1, 5])
def test_ssm_state_step_matches(s):
    """``ssm`` from a drawn state: the output, the SSD state and the conv
    history it leaves."""
    jcfg, cfg, jp, tp = _ssm_pair()
    rng = np.random.default_rng(14)
    jx, tx = both(rng, (B, s, cfg.d_model))
    jst, tst = cache_pair(rng, {
        "h": (B, cfg.n_heads, cfg.head_dim, cfg.d_state),
        "conv": (B, cfg.conv_width - 1, cfg.conv_dim)})
    want, jnew = jax.jit(lambda p, x, st: jssm.ssm(
        p, x, tap=jpex.NULL, cfg=jcfg, state=st))(jp, jx, jst)
    got = tssm.ssm(tp, tx, tap=pex.NULL, cfg=cfg, state=tst)
    close(got, want)
    held(tst, jnew)


def test_init_ssm_state_matches():
    jcfg, cfg, _, _ = _ssm_pair()
    want = jssm.init_ssm_state(3, jcfg, dtype=jnp.bfloat16)
    got = tssm.init_ssm_state(3, cfg, dtype=torch.bfloat16, device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


# --- every family's caches ----------------------------------------------------

ARCHS = ["llama3.2-1b", "deepseek-v2-236b", "rwkv6-3b", "zamba2-7b",
         "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_and_interop_match_reference(arch):
    """The port's ``init_caches``, carried to the reference's layout by
    ``interop``, has the reference's tree, shapes and dtypes (bf16); the
    reference's caches carried in and back give its arrays exactly."""
    jspec, spec = jreg.get(arch), registry.get(arch)
    fam = spec.family
    jcfg = jreg.serving_config(jspec, dataclasses.replace(
        jspec.smoke(), dtype="bfloat16"), JShape("t", "decode", 8, 3))
    cfg = registry.serving_config(spec, dataclasses.replace(
        spec.smoke(), dtype="bfloat16"), ShapeSpec("t", "decode", 8, 3))
    want = jax.tree_util.tree_map(
        np.asarray, jreg.family_module(jspec).init_caches(3, jcfg))
    own = registry.family_module(spec).init_caches(3, cfg, device="cpu")
    got = interop.caches_to_numpy(own, fam)
    assert jax.tree_util.tree_map(lambda x: x.shape, got) \
        == jax.tree_util.tree_map(lambda x: x.shape, want)
    for path, x in jax.tree_util.tree_leaves_with_path(want):
        port_dtype = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[str(x.dtype)]
        assert _leaf(own, fam, path).dtype == port_dtype, path
    rng = np.random.default_rng(15)
    drawn = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), want)
    back = interop.caches_to_numpy(
        interop.caches_from_numpy(drawn, fam, device="cpu"), fam)
    for path, x in jax.tree_util.tree_leaves_with_path(drawn):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[path], x)


def _leaf(caches, fam, path):
    """The port's cache leaf at the reference's key path (its stacked axes
    taken at 0)."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    node = caches
    for depth_path, depth in interop.CACHE_STACKS[fam].items():
        if tuple(keys[:len(depth_path)]) == depth_path:
            for k in depth_path:
                node = node[k]
            for _ in range(depth):
                node = node[0]
            keys = keys[len(depth_path):]
            break
    for k in keys:
        node = node[k]
    return node
