"""The port's sort methods against the JAX package's and numpy.

Every case runs the same numpy keys through ``gpuradixsort_tpu``'s
``method="fused"`` or ``"radix"`` (jnp references on the CPU) and through
the port's, and requires the padded output buffers to be equal element for
element, pad rows included, and the live prefix to equal ``np.sort`` /
``np.argsort(kind="stable")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu import config as jconfig
from gpuradixsort_tpu.core import table as jtable
from gpuradixsort_tpu.ops import sort as jsort
from gpuradixsort_tpu_torch import config as tconfig
from gpuradixsort_tpu_torch.core import table as ttable
from gpuradixsort_tpu_torch.kernels import radix as tradix
from gpuradixsort_tpu_torch.kernels.key_bits import (
    SortArgs,
    key_bits,
    pass_mask,
    pass_plan,
    plan_of_mask,
)
from gpuradixsort_tpu_torch.ops import sort as tsort
from gpuradixsort_tpu_torch.ops.permute import gather_rows
from gpuradixsort_tpu_torch.utils import timing, verify

torch.set_num_threads(1)

CFG = tconfig.EngineConfig()
JCFG = jconfig.EngineConfig()
BLOCK = CFG.block


def _keysets(rng, n):
    return {
        "random": rng.integers(0, 2**32, size=n, dtype=np.uint32),
        "presorted": np.arange(n, dtype=np.uint32),
        "all_equal": np.full(n, 0xDEADBEEF, dtype=np.uint32),
        "few_values": rng.integers(0, 4, size=n, dtype=np.uint32),
        # Live keys equal to PAD_KEY must stay before the pad rows.
        "max_keys": np.where(
            rng.integers(0, 2, size=n).astype(bool), np.uint32(0xFFFFFFFF),
            rng.integers(0, 100, size=n, dtype=np.uint32),
        ),
    }


def _check_pairs(keys, cfg, jcfg, method="fused"):
    s, p = tsort.sort_pairs(keys, cfg, method=method, device="cpu")
    js, jp = jsort.sort_pairs(jtable.make_key_column(keys, jcfg), jcfg, method=method)
    np.testing.assert_array_equal(s.data.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(jp.data))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(s.to_numpy(), keys[order])
    np.testing.assert_array_equal(p.to_numpy(), order.astype(np.uint32))
    return s


@pytest.mark.parametrize("n", [1000, 3 * BLOCK + 17])
def test_sort_pairs_matches_jax_fused(n, rng):
    for name, keys in _keysets(rng, n).items():
        _check_pairs(keys, CFG, JCFG)


@pytest.mark.parametrize("n", [1, 127, 1024, BLOCK - 1, BLOCK + 1])
def test_sort_keys_ragged_matches_jax_fused(n, rng):
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    keys[: min(n, 3)] = 0xFFFFFFFF
    out = tsort.sort_keys(keys, CFG, method="fused", device="cpu")
    jout = jsort.sort_keys(jtable.make_key_column(keys, JCFG), JCFG, method="fused")
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data))
    np.testing.assert_array_equal(out.to_numpy(), np.sort(keys))
    assert out.length == n


def test_reference_parity_config_one_bit(rng):
    cfg, jcfg = tconfig.REFERENCE_PARITY_CONFIG, jconfig.REFERENCE_PARITY_CONFIG
    keys = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    _check_pairs(keys, cfg, jcfg)


@pytest.mark.parametrize("bits", [2, 4])
def test_radix_widths_match_jax(bits, rng):
    cfg, jcfg = tconfig.EngineConfig(radix_bits=bits), jconfig.EngineConfig(radix_bits=bits)
    keys = rng.integers(0, 2**32, size=2 * BLOCK, dtype=np.uint32)
    _check_pairs(keys, cfg, jcfg)


def test_sort_table_matches_jax(rng):
    n = 2 * BLOCK - 5
    keys = rng.integers(0, 1000, size=n, dtype=np.uint32)
    payload = rng.integers(0, 2**31, size=(n, 16)).astype(np.int32)  # 64-byte rows
    other = rng.standard_normal(n).astype(np.float32)
    jt = jtable.table_from_arrays(JCFG, payload=payload, other=other)
    jt = jt.with_column("key", jtable.make_key_column(keys, JCFG))
    jout = jsort.sort_table(jt, "key", JCFG, method="fused")
    out = tsort.sort_table(ttable.table_from_jax(jt, device="cpu"), "key", CFG, method="fused")
    assert out.names() == jout.names()
    # Full padded buffers: the port reads the index as int32 as the JAX
    # package does, so pad rows (index PAD_INDEX -> -1 -> clipped to 0)
    # gather row 0 in both.
    for name in jout.names():
        np.testing.assert_array_equal(out[name].data.numpy(), np.asarray(jout[name].data))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out["payload"].to_numpy(), payload[order])
    np.testing.assert_array_equal(out["other"].to_numpy(), other[order])
    np.testing.assert_array_equal(out["payload"].data.numpy()[n:], np.repeat(payload[:1], 5, 0))


def test_torch_method_and_auto_agree_with_fused(rng):
    keys = rng.integers(0, 50, size=BLOCK + 3, dtype=np.uint32)
    s, p = tsort.sort_pairs(keys, CFG, method="fused", device="cpu")
    for method in ("torch", "auto"):
        s2, p2 = tsort.sort_pairs(keys, CFG, method=method, device="cpu")
        np.testing.assert_array_equal(s2.data.numpy(), s.data.numpy())
        np.testing.assert_array_equal(p2.data.numpy(), p.data.numpy())


def test_torch_method_matches_jax_xla_on_high_and_pad_keys(rng):
    # The library baseline sorts the sign-flipped int32 view: keys at and
    # above 2^31 (negative in that view) and live keys equal to PAD_KEY must
    # keep the JAX package's stable uint32 order, live rows before pad rows.
    n = 2 * BLOCK + 17
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    keys = np.where(rng.integers(0, 2, size=n).astype(bool), rng.choice(edges, size=n),
                    rng.integers(0, 2**32, size=n, dtype=np.uint32))
    s, p = tsort.sort_pairs(keys, CFG, method="torch", device="cpu")
    js, jp = jsort.sort_pairs(jtable.make_key_column(keys, JCFG), JCFG, method="xla")
    np.testing.assert_array_equal(s.data.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(jp.data))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(p.to_numpy(), order.astype(np.uint32))
    assert (keys >= 2**31).sum() > n // 4 and (keys == 0xFFFFFFFF).sum() > 100


def test_unported_and_unknown_methods_raise():
    # Every method of the port sorts; the JAX package's "xla" is not one.
    keys = np.arange(10, dtype=np.uint32)[::-1].copy()
    for method in tsort.METHODS:
        np.testing.assert_array_equal(tsort.sort_keys(keys, CFG, method=method, device="cpu").to_numpy(),
                                      np.sort(keys))
    with pytest.raises(ValueError, match="unknown sort method"):
        tsort.sort_pairs(keys, CFG, method="xla", device="cpu")


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_radix_method_matches_jax(bits, rng):
    cfg, jcfg = tconfig.EngineConfig(radix_bits=bits), jconfig.EngineConfig(radix_bits=bits)
    n = 2 * BLOCK + 17 if bits > 1 else 1500  # 32 one-bit passes: keep it small
    for name, keys in _keysets(rng, n).items():
        _check_pairs(keys, cfg, jcfg, method="radix")
        out = tsort.sort_keys(keys, cfg, method="radix", device="cpu")
        jout = jsort.sort_keys(jtable.make_key_column(keys, jcfg), jcfg, method="radix")
        np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_radix_sort_padded_carries_columns(bits, rng):
    cfg, jcfg = tconfig.EngineConfig(radix_bits=bits), jconfig.EngineConfig(radix_bits=bits)
    keys = rng.integers(0, 1000, BLOCK, dtype=np.uint32)
    idx = np.arange(BLOCK, dtype=np.uint32)
    extra = rng.integers(-(2**31), 2**31, (BLOCK, 2)).astype(np.int32)  # 2-D rows
    jkeys, (jidx, jextra) = jsort._sort_padded(
        jnp.asarray(keys), (jnp.asarray(idx), jnp.asarray(extra)), jcfg, None, 2)
    tkeys, (tidx, textra) = tsort._sort_padded(
        torch.from_numpy(keys), (torch.from_numpy(idx), torch.from_numpy(extra)), cfg)
    for got, want in ((tkeys, jkeys), (tidx, jidx), (textra, jextra)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(textra.numpy(), extra[np.argsort(keys, kind="stable")])


def _nine_columns(rng, n):
    """Nine columns of n rows in dtypes JAX keeps, two of them 2-D: more than
    one dest_scatter launch takes."""
    return (
        np.arange(n, dtype=np.uint32),
        rng.integers(-(2**31), 2**31, (n, 4)).astype(np.int32),
        rng.standard_normal(n).astype(np.float32),
        rng.integers(0, 2**32, n, dtype=np.uint32),
        rng.integers(-(2**15), 2**15, n).astype(np.int16),
        rng.integers(0, 2, n).astype(bool),
        rng.integers(0, 256, (n, 5)).astype(np.uint8),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.standard_normal(n).astype(np.float32),
    )


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_radix_sort_padded_carries_nine_columns(bits, rng):
    cfg, jcfg = tconfig.EngineConfig(radix_bits=bits), jconfig.EngineConfig(radix_bits=bits)
    keys = rng.integers(0, 1 << 12, BLOCK, dtype=np.uint32)  # many equal keys
    carried = _nine_columns(rng, BLOCK)
    jkeys, jcarried = jsort._sort_padded(
        jnp.asarray(keys), tuple(jnp.asarray(c) for c in carried), jcfg, None, len(carried))
    tkeys, tcarried = tsort._sort_padded(
        torch.from_numpy(keys), tuple(torch.from_numpy(c) for c in carried), cfg)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    order = np.argsort(keys, kind="stable")
    for got, want, c in zip(tcarried, jcarried, carried):
        assert got.dtype == getattr(torch, str(c.dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), c[order])


def test_radix8_auto_matches_jax(rng):
    # The JAX package's "auto" is "radix" off the TPU; the port's must sort
    # 8-bit digits too, where the fused bucketize takes at most 16 buckets.
    cfg, jcfg = tconfig.EngineConfig(radix_bits=8), jconfig.EngineConfig(radix_bits=8)
    for name, keys in _keysets(rng, 5000).items():
        out = tsort.sort_keys(keys, cfg, device="cpu")
        jout = jsort.sort_keys(jtable.make_key_column(keys, jcfg), jcfg)
        np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data))
        s, p = tsort.sort_pairs(keys, cfg, device="cpu")
        js, jp = jsort.sort_pairs(jtable.make_key_column(keys, jcfg), jcfg)
        np.testing.assert_array_equal(s.data.numpy(), np.asarray(js.data))
        np.testing.assert_array_equal(p.data.numpy(), np.asarray(jp.data))
    assert tsort._resolve_method("auto", cfg) == "radix"
    assert tsort._resolve_method("auto", CFG) == "fused"


def test_constant_digit_passes_are_skipped():
    before = tsort.skipped_passes()
    keys = np.full(BLOCK, 7, dtype=np.uint32)  # no pads: every digit constant
    s, p = tsort.sort_pairs(keys, CFG, method="fused", device="cpu")
    assert tsort.skipped_passes() - before == CFG.num_passes
    np.testing.assert_array_equal(p.to_numpy(), np.arange(BLOCK, dtype=np.uint32))
    before = tsort.skipped_passes()
    perm = np.random.default_rng(3).permutation(1 << 14).astype(np.uint32)
    s, _ = tsort.sort_pairs(perm, CFG, method="fused", device="cpu")
    # Keys below 2^14 have constant digits in passes 4..7.
    assert tsort.skipped_passes() - before == 4
    assert verify.is_permutation_sorted(s.valid())


def _skip_keys(name: str) -> np.ndarray:
    """The key sets of the constant-digit skip's tests, each from its own seed."""
    gen = np.random.default_rng(sorted(SKIP_SETS).index(name))
    if name == "all equal, no pads":
        return np.full(BLOCK, 7, dtype=np.uint32)
    if name == "permutation of 2^14":
        return gen.permutation(1 << 14).astype(np.uint32)
    if name == "random":
        return gen.integers(0, 2**32, size=2 * BLOCK, dtype=np.uint32)
    if name == "pad rows":  # small keys: only the pads' PAD_KEY sets the high digits
        return gen.integers(0, 1 << 12, size=BLOCK + 100, dtype=np.uint32)
    if name == "fixed middle digits":  # bits 16-23 constant: 4-bit passes 4 and 5 skip
        keys = gen.integers(0, 2**32, size=BLOCK, dtype=np.uint32)
        return (keys & np.uint32(0xFF00FFFF)) | np.uint32(0x00AB0000)
    return np.where(gen.integers(0, 2, size=BLOCK + 5).astype(bool),  # "live PAD_KEY"
                    np.uint32(tconfig.PAD_KEY), gen.integers(0, 100, size=BLOCK + 5,
                                                             dtype=np.uint32))


SKIP_SETS = ("all equal, no pads", "permutation of 2^14", "random", "pad rows", "live PAD_KEY",
             "fixed middle digits")


def _jax_pass_mask(padded: np.ndarray, cfg) -> int:
    """The JAX package's per-pass criterion, from the tile histograms of the padded buffer:
    pass p runs when more than one bucket of their sum is filled."""
    mask = 0
    for p in range(cfg.num_passes):
        digits = ((padded >> np.uint32(p * cfg.radix_bits)) & np.uint32(cfg.radix - 1))
        hist = np.stack([np.bincount(t, minlength=cfg.radix)
                         for t in digits.astype(np.int64).reshape(-1, cfg.tile)])
        if np.sum(hist.sum(axis=0) > 0) > 1:
            mask |= 1 << p
    return mask


@pytest.mark.parametrize("name", SKIP_SETS)
def test_key_bits_plain_matches_numpy(name):
    keys = _skip_keys(name)
    for buf in (keys, ttable.make_key_column(keys, CFG, device="cpu").data.numpy()):
        words = key_bits(torch.from_numpy(buf)).numpy()
        assert words.dtype == np.uint32
        assert (words[0], words[1]) == (np.bitwise_and.reduce(buf), np.bitwise_or.reduce(buf))


def test_key_bits_of_no_keys():
    # An empty buffer fills no bucket: all-ones and zero, so no digit varies.
    words = key_bits(torch.empty(0, dtype=torch.uint32)).numpy()
    assert (words[0], words[1]) == (0xFFFFFFFF, 0)
    assert pass_mask(torch.empty(0, dtype=torch.uint32), CFG) == 0


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("name", SKIP_SETS)
def test_pass_mask_matches_jax_criterion(name, bits):
    cfg = tconfig.EngineConfig(radix_bits=bits)
    padded = ttable.make_key_column(_skip_keys(name), cfg, device="cpu").data
    assert pass_mask(padded, cfg) == _jax_pass_mask(padded.numpy(), cfg)


@pytest.mark.parametrize("name", SKIP_SETS)
def test_skip_sets_match_jax_fused(name):
    keys = _skip_keys(name)
    want = _jax_pass_mask(ttable.make_key_column(keys, CFG, device="cpu").data.numpy(), CFG)
    before = tsort.skipped_passes()
    _check_pairs(keys, CFG, JCFG)
    skipped = tsort.skipped_passes() - before
    assert skipped == CFG.num_passes - bin(want).count("1")
    assert not tsort._SORT_GRAPHS  # CPU tensors never capture a graph


def _mask_keys(mask: int, n: int) -> np.ndarray:
    """n keys whose digit p varies exactly where bit p of ``mask`` is set (seeded by the mask)."""
    return verify.mask_keys(mask, n, CFG, np.random.default_rng(mask))


def _routes(plan) -> list:
    """(source, destination) of each pass that runs, over (input, R, S) = (0, 1, 2)."""
    buffers = (tradix.INPUT, tradix.RESULT, tradix.SCRATCH)
    routes = [tradix.planned_route(torch.as_tensor(plan, dtype=torch.int32), p, buffers)
              for p in range(len(plan))]
    return [r for r in routes if r is not None]


def test_plan_routes_every_mask():
    # Every mask of 4-bit digits over 8 passes on two tiles: the plan from
    # the AND/OR words equals the plan of the JAX package's criterion; the
    # passes that run read the input first, then each the buffer the one
    # before wrote, never the buffer they write, and the last writes R; the
    # plain versions routed by it sort the pairs stably, write nothing of
    # the input and count the skipped passes.
    n = 2 * CFG.tile
    idx_np = np.arange(n, dtype=np.uint32)
    skipped = torch.zeros(1, dtype=torch.int64)
    for mask in range(1 << CFG.num_passes):
        keys_np = _mask_keys(mask, n)
        assert _jax_pass_mask(keys_np, CFG) == mask
        keys, idx = torch.from_numpy(keys_np.copy()), torch.from_numpy(idx_np.copy())
        before = int(skipped)
        plan = pass_plan(keys, CFG, skipped)
        assert plan.tolist() == plan_of_mask(mask, CFG.num_passes), mask
        routes = _routes(plan)
        assert len(routes) == max(1, bin(mask).count("1"))  # or the copy
        assert routes[0][0] == tradix.INPUT and routes[-1][1] == tradix.RESULT
        assert all(dst in (tradix.RESULT, tradix.SCRATCH) and dst != src for src, dst in routes)
        assert all(a[1] == b[0] for a, b in zip(routes, routes[1:]))
        assert int(skipped) - before == CFG.num_passes - bin(mask).count("1")
        result = (torch.empty_like(keys), torch.empty_like(idx))
        out_keys, out_idx = tsort._fused_passes(SortArgs(keys, idx, result, n), CFG, skipped)
        order = np.argsort(keys_np, kind="stable")
        np.testing.assert_array_equal(out_keys.numpy(), keys_np[order], err_msg=f"{mask:#x}")
        np.testing.assert_array_equal(out_idx.numpy(), order.astype(np.uint32))
        np.testing.assert_array_equal(keys.numpy(), keys_np)  # the input is never written
        np.testing.assert_array_equal(idx.numpy(), idx_np)


def test_plan_of_mask_layout():
    # -1 skipped, else source | destination << 2 over the input (0), R (1)
    # and S (2): the passes that run alternate R and S backwards from the
    # last, which writes R, and the first reads the input; with no pass, the
    # last one copies the input into R.
    e, inp, r, s = tradix.plan_entry, tradix.INPUT, tradix.RESULT, tradix.SCRATCH
    assert (e(inp, r), e(inp, s), e(r, s), e(s, r)) == (4, 8, 9, 6)
    assert plan_of_mask(0xFF, 8) == [e(inp, s), e(s, r), e(r, s), e(s, r), e(r, s), e(s, r),
                                     e(r, s), e(s, r)]
    assert plan_of_mask(0b01010100, 8) == [-1, -1, e(inp, r), -1, e(r, s), -1, e(s, r), -1]
    assert plan_of_mask(0b00011000, 8) == [-1, -1, -1, e(inp, s), e(s, r), -1, -1, -1]
    assert plan_of_mask(0, 8) == [-1] * 7 + [e(inp, r)]
    assert plan_of_mask(0, 1) == [e(inp, r)]


PLAN_MASKS = {"none": 0, "all": 0xFF, "the high two constant": 0x3F, "one pass": 0b00010000}


@pytest.mark.parametrize("name", PLAN_MASKS)
def test_plan_masks_match_jax_fused_sort(name):
    # One block through the JAX package's _fused_sort_padded (jnp
    # references on the CPU) and the port's, padded buffers equal.
    keys_np = _mask_keys(PLAN_MASKS[name], BLOCK)
    idx_np = np.arange(BLOCK, dtype=np.uint32)
    js, ji, _ = jsort._fused_sort_padded(jnp.asarray(keys_np), jnp.asarray(idx_np), JCFG)
    before = tsort.skipped_passes()
    keys, idx = torch.from_numpy(keys_np.copy()), torch.from_numpy(idx_np.copy())
    ts, ti, overflow = tsort._fused_sort_padded(keys, idx, CFG)
    assert not overflow
    # A new buffer, whichever passes ran, and the input unwritten.
    assert ts.data_ptr() not in (keys.data_ptr(), idx.data_ptr())
    np.testing.assert_array_equal(keys.numpy(), keys_np)
    np.testing.assert_array_equal(idx.numpy(), idx_np)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tsort.skipped_passes() - before == CFG.num_passes - bin(PLAN_MASKS[name]).count("1")
    order = np.argsort(keys_np, kind="stable")
    np.testing.assert_array_equal(ti.numpy(), order.astype(np.uint32))


def test_stale_rows_past_length_are_repadded(rng):
    keys = rng.integers(0, 2**32, size=BLOCK, dtype=np.uint32)
    # A column whose rows past `length` hold small garbage keys.
    col = ttable.Column(torch.from_numpy(keys.copy()), 100)
    jcol = jtable.Column(jtable.make_key_column(keys, JCFG).data, 100)
    out = tsort.sort_keys(col, CFG, method="fused")
    jout = jsort.sort_keys(jcol, JCFG, method="fused")
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data))
    np.testing.assert_array_equal(out.to_numpy(), np.sort(keys[:100]))


def test_gather_rows_clips(rng):
    values = torch.from_numpy(rng.integers(0, 2**32, size=(10, 3), dtype=np.uint32))
    src = torch.tensor([-1, 0, 9, 12], dtype=torch.int32)
    out = gather_rows(values, src)
    np.testing.assert_array_equal(out.numpy(), values.numpy()[[0, 0, 9, 9]])


def test_verify_helpers():
    keys = torch.tensor([1, 5, 0xFFFFFFFF, 0xFFFFFFFF], dtype=torch.uint32)
    assert verify.is_sorted(keys)
    assert not verify.is_sorted(np.array([2, 1, 3]))
    assert verify.is_sorted(np.array([2, 1, 3]), length=1)
    assert verify.is_permutation_sorted(np.arange(5, dtype=np.uint32))
    assert not verify.is_permutation_sorted(np.array([1, 0], dtype=np.uint32))
    assert bool(verify.device_is_sorted(keys))
    descending = torch.tensor([0xFFFFFFFF, 5, 1], dtype=torch.uint32)
    assert not bool(verify.device_is_sorted(descending))
    assert bool(verify.device_is_sorted(keys[:1]))


def test_timing_needs_a_card():
    st = timing.StageTimes()
    st.add("hist", 12e-6)
    assert st.report() == "hist: 12 us"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.cuda_time_ms(lambda: None)


@pytest.mark.parametrize("entry", ["sort_keys", "sort_pairs", "sort_table"])
@pytest.mark.parametrize("form", ["column", "ragged column", "tensor", "ragged tensor"])
def test_sorts_refuse_2_31_padded_rows(entry, form):
    # Meta tensors allocate nothing.  2^31 padded rows would wrap the int32
    # offsets, destinations and index column, so every sort entry refuses
    # them before any kernel runs, also where padding makes the 2^31.
    rows = 2**31 - 1 if form.startswith("ragged") else 2**31
    data = torch.empty(2**31 if form == "ragged column" else rows, dtype=torch.uint32,
                       device="meta")
    keys = ttable.Column(data, rows) if form.endswith("column") else data
    if entry == "sort_table":
        if not form.endswith("column"):
            keys = ttable.make_column(data, CFG)  # a payload column takes any length
        call = lambda: tsort.sort_table(ttable.Table({"k": keys}), "k", CFG)  # noqa: E731
    else:
        call = lambda: getattr(tsort, entry)(keys, CFG, method="fused")  # noqa: E731
    with pytest.raises(ValueError, match=r"2\^31.*int32"):
        call()


def test_sorts_take_2_31_less_a_block():
    # The largest padded length below 2^31 passes the check.
    rows = 2**31 - CFG.block
    col = ttable.make_key_column(torch.empty(rows, dtype=torch.uint32, device="meta"), CFG)
    assert col.padded_length == rows
    assert tsort._key_column(col, CFG) is col


# Live lengths of a one-block buffer: none, one, a tile less one, a multiple
# of the tile and one past it.
LIVE_LENGTHS = [0, 1, CFG.tile - 1, 3 * CFG.tile, 3 * CFG.tile + 1]
LIVE_KINDS = ["random", "live PAD_KEY", "all equal"]


def _live_keys(kind: str, n: int, gen) -> np.ndarray:
    if kind == "all equal":  # every digit constant: the sort is the plan's copy pass
        return np.full(n, 0xDEADBEEF, dtype=np.uint32)
    keys = gen.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "live PAD_KEY":  # live rows equal to the pads stay before them
        keys[gen.random(n) < 0.3] = np.uint32(tconfig.PAD_KEY)
    return keys


def _stale_columns(keys: np.ndarray, length: int, padded: int, gen):
    """One key column for each package, its rows past ``length`` stale: non-pad garbage."""
    buf = gen.integers(0, 1 << 16, padded, dtype=np.uint32)
    buf[:length] = keys[:length]
    return ttable.Column(torch.from_numpy(buf.copy()), length), jtable.Column(jnp.asarray(buf), length)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("length", LIVE_LENGTHS)
@pytest.mark.parametrize("kind", LIVE_KINDS)
def test_fused_sorts_of_live_lengths_match_jax(bits, length, kind):
    # The fused sort_pairs, sort_keys and sort_table of a key column whose
    # rows past its length hold stale keys: the port's plain route (the
    # made index, the rows past the length read as pads) against the JAX
    # package's, which re-pads with jnp.where and makes the index with
    # jnp.arange; padded buffers equal element for element.
    cfg, jcfg = tconfig.EngineConfig(radix_bits=bits), jconfig.EngineConfig(radix_bits=bits)
    gen = np.random.default_rng([bits, length, LIVE_KINDS.index(kind)])
    padded = cfg.block
    keys = _live_keys(kind, padded, gen)
    col, jcol = _stale_columns(keys, length, padded, gen)
    held = col.data.clone()
    s, p = tsort.sort_pairs(col, cfg, method="fused")
    js, jp = jsort.sort_pairs(jcol, jcfg, method="fused")
    np.testing.assert_array_equal(s.data.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(jp.data))
    order = np.argsort(keys[:length], kind="stable")
    np.testing.assert_array_equal(p.to_numpy(), order.astype(np.uint32))
    np.testing.assert_array_equal(
        tsort.sort_keys(col, cfg, method="fused").data.numpy(),
        np.asarray(jsort.sort_keys(jcol, jcfg, method="fused").data))
    payload = gen.integers(0, 2**31, (padded, 2)).astype(np.int32)
    table = ttable.Table({"key": col, "v": ttable.Column(torch.from_numpy(payload), length)})
    jtable_ = jtable.Table({"key": jcol, "v": jtable.Column(jnp.asarray(payload), length)})
    out, jout = (tsort.sort_table(table, "key", cfg, method="fused"),
                 jsort.sort_table(jtable_, "key", jcfg, method="fused"))
    for name in ("key", "v"):
        np.testing.assert_array_equal(out[name].data.numpy(), np.asarray(jout[name].data))
    assert torch.equal(col.data, held)  # the input, stale rows and all, is not written


@pytest.mark.parametrize("length", LIVE_LENGTHS + [2 * BLOCK - 1, 2 * BLOCK])
def test_made_index_matches_the_explicit_index(length):
    # The made-index route (the buffer and its length, nothing built) and the
    # explicit-index route (the re-padded buffer with the index column, every
    # row live) give one result.
    gen = np.random.default_rng(length)
    keys = _live_keys("live PAD_KEY", 2 * BLOCK, gen)
    col, _ = _stale_columns(keys, length, 2 * BLOCK, gen)
    made = tsort._fused_sort_live(col.data, length, CFG)
    repadded = tsort._repadded(col)
    explicit = tsort._fused_sort_padded(repadded.data, tsort._index_column(repadded), CFG)
    for a, b in zip(made, explicit[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tsort._repadded(ttable.Column(col.data, 2 * BLOCK)).data is col.data
