"""The Python side of B1's and B3's cluster launch (one thread-block cluster
of ``ctas_per_channel`` CTAs per channel, csrc/track_block.cu): the rank
slices of a window, the choice of the cluster size, a plain model of the
kernel's rank-order reduction against the port's gather correlator, and
the plain path at every forced size.  The kernels themselves are held to
their plain versions on the card (tests/test_torch_kernels.py,
chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.scripts import mega_vmem_bisect as s2
from softgnss_tpu_torch.scripts.inputs import channel_inputs
from softgnss_tpu_torch.signals.nco import carrier_turns, ceil_chip_index, chips_to_q, sin_turns
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import scan

torch.set_num_threads(1)

SEED = 20261016
FRONT_ENDS = {"default": sgt.default_config(), "fast": sgt.fast_config()}


# --- (a) rank slices --------------------------------------------------------


@pytest.mark.parametrize("kn", mk.CLUSTER_SIZES)
@pytest.mark.parametrize("front_end", FRONT_ENDS)
def test_rank_slices_tile_the_window(front_end, kn):
    """The kN slices are consecutive, cover [0, win) exactly without
    overlap, and every edge inside the window lies on a 16-byte boundary;
    the kernel is handed the same chunk."""
    cfg = FRONT_ENDS[front_end]
    win = cfg.track_window
    slices = mk.rank_slices(win, kn)
    assert len(slices) == kn
    covered = np.zeros(win, np.int64)
    for lo, hi in slices:
        assert 0 <= lo <= hi <= win
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert [lo for lo, _ in slices[1:]] == [hi for _, hi in slices[:-1]]
    for lo, hi in slices:
        assert lo % 16 == 0 and (hi % 16 == 0 or hi == win)
    chunk = mk.rank_chunk(win, kn)
    assert chunk % 16 == 0 and chunk * kn >= win and (chunk - 16) * kn < win
    _, hi = mk._kernel_params(cfg, 64, 8, win, kn)
    assert hi[9] == chunk


# --- (b) the cluster size ---------------------------------------------------

#: clusters of each size an H100 SXM holds at once in this stub: 132 SMs,
#: GPCs of 16-18 SMs (at most 7 clusters of 16)
H100_LIKE = {2: 66, 4: 33, 8: 16, 16: 7}


def _stub(table, asked):
    def max_clusters(kn):
        asked.append(kn)
        return table[kn]
    return max_clusters


@pytest.mark.parametrize("n_ch, preferred, want", [(8, 8, 8), (12, 8, 8), (16, 8, 8),
                                                   (8, 16, 8), (12, 16, 8), (20, 8, 4),
                                                   (7, 16, 16), (40, 16, 2)])
def test_cluster_size_takes_the_default_or_the_next_that_fits(n_ch, preferred, want):
    asked = []
    if want == preferred:
        got = mk.choose_ctas_per_channel(n_ch, _stub(H100_LIKE, asked), preferred)
    else:
        with pytest.warns(UserWarning, match=f"launching {want} CTAs per channel"):
            got = mk.choose_ctas_per_channel(n_ch, _stub(H100_LIKE, asked), preferred)
    assert got == want
    assert 1 not in asked and asked == sorted(asked, reverse=True) and asked[0] == preferred


#: the same card's counts at 256 threads per CTA, sharing SMs and with one
#: CTA per SM (``max_active_clusters``, with and without ``alone``; read on
#: an H100 80GB HBM3)
H100_SHARED = {2: 132, 4: 62, 8: 30, 16: 14}
H100_ALONE = {2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("n_ch, want", [(3, 16), (7, 16), (8, 8), (12, 8), (15, 8), (16, 4),
                                        (40, 2), (66, 2)])
def test_cluster_size_gives_each_cluster_sms_of_its_own(n_ch, want):
    """The largest size whose clusters all fit at one CTA per SM, without a
    warning: 16 CTAs up to 7 channels, 8 for the cells' 8 channels."""
    asked = []
    got = mk.choose_ctas_per_channel(n_ch, _stub(H100_SHARED, []), 16,
                                     alone=_stub(H100_ALONE, asked))
    assert got == want
    assert asked == [k for k in (16, 8, 4, 2) if k >= want]


def test_cluster_size_shares_sms_where_no_size_gives_them_alone():
    """Past 66 channels no size gives each cluster SMs of its own: the
    choice falls back to the sizes that fit sharing SMs, with a warning."""
    with pytest.warns(UserWarning, match="launching 2 CTAs per channel"):
        got = mk.choose_ctas_per_channel(100, _stub(H100_SHARED, []), 16,
                                         alone=_stub(H100_ALONE, []))
    assert got == 2
    with pytest.raises(RuntimeError, match="ctas_per_channel=1"):
        mk.choose_ctas_per_channel(200, _stub(H100_SHARED, []), 16, alone=_stub(H100_ALONE, []))


def test_cluster_size_never_falls_to_one_cta():
    """No cluster fits: the choice raises and names the explicit way out."""
    asked = []
    with pytest.raises(RuntimeError, match="ctas_per_channel=1"):
        mk.choose_ctas_per_channel(70, _stub(H100_LIKE, asked), 16)
    assert asked == [16, 8, 4, 2]
    assert mk.choose_ctas_per_channel(70, _stub(H100_LIKE, []), 1) == 1   # asked for


def test_launch_size_forced_and_default():
    """A forced size is taken as given, without asking the card; the
    default threads per CTA is THREADS_PER_CTA; bad sizes raise."""
    cpu = torch.device("cpu")
    assert mk.launch_size(cpu, False, 8, 38320, 4) == (4, mk.THREADS_PER_CTA)
    assert mk.launch_size(cpu, True, 12, 38320, 16, 128) == (16, 128)
    assert mk.CTAS_PER_CHANNEL in mk.CLUSTER_SIZES and mk.CTAS_PER_CHANNEL > 1
    for bad in ({"ctas_per_channel": 3}, {"ctas_per_channel": 32}, {"threads_per_cta": 48},
                {"threads_per_cta": 1024}):
        with pytest.raises(ValueError):
            mk.launch_size(cpu, False, 8, 38320, **bad)


# --- (c) the rank-order reduction -------------------------------------------


def _window_products(cfg, rng, n_ch: int):
    """Seeded inputs of one ms of ``n_ch`` channels over a whole window at
    ``cfg``: int8 samples masked to the true span [o, o + blk), the
    carrier wiped off, Q40 code phases at every window index."""
    win = cfg.track_window
    blk = cfg.samples_per_code
    o = torch.from_numpy(rng.integers(0, win - blk + 1, n_ch))
    k = torch.arange(win, dtype=torch.int64)
    raw = torch.from_numpy(rng.integers(-8, 8, (n_ch, win)).astype(np.float32))
    raw = torch.where((k >= o[:, None]) & (k < (o + blk)[:, None]), raw, 0.0)
    phase = torch.from_numpy(rng.integers(-2**31, 2**31, n_ch).astype(np.int32))
    w = torch.from_numpy(rng.integers(-2**27, 2**27, n_ch).astype(np.int32))
    turns = carrier_turns((phase.to(torch.int64) - w.to(torch.int64) * o)[:, None],
                          w[:, None], k)
    i_bb, q_bb = sin_turns(turns) * raw, sin_turns(turns + 0.25) * raw
    step = torch.from_numpy(rng.integers(29_440_000_000, 29_460_000_000, n_ch))  # ~1.023 MHz
    rem = torch.from_numpy(rng.integers(0, 2**40, n_ch))
    tq = (rem - step * o)[:, None] + step[:, None] * k
    pads = torch.from_numpy(rng.choice([-1.0, 1.0], (n_ch, 1025)).astype(np.float32))
    return pads, tq, i_bb, q_bb


def rank_order_correlate(cfg, pads, tq, i_bb, q_bb, kn: int):
    """The kernel's reduction, modelled: per rank a float64 partial of the
    float32 products over its window slice, the kn partials summed in rank
    order, rounded once to float32."""
    half_q = chips_to_q(cfg.dll_correlator_spacing)
    codes = [pads.gather(-1, ceil_chip_index(tq + d).clamp(0, 1024).to(torch.int64))
             for d in (-half_q, 0, half_q)]
    sums = []
    for bb in (i_bb, q_bb):
        for code in codes:
            prod = (code * bb).to(torch.float64)
            parts = [prod[:, lo:hi].sum(-1) for lo, hi in mk.rank_slices(prod.shape[1], kn)]
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            sums.append(total.to(torch.float32))
    return tuple(sums)


@pytest.mark.parametrize("kn", mk.CLUSTER_SIZES)
def test_rank_order_reduction_matches_the_gather_correlator(kn, capsys):
    """At the default front end, 4 ms x 8 channels x 6 sums: every sum of
    the rank-order model within one float32 ulp of _correlate_gather's
    (float64 over the whole window, rounded once), and the count of sums
    that are bit-equal stated."""
    cfg = sgt.default_config()
    rng = np.random.default_rng(SEED + kn)
    n_sums = n_equal = 0
    for _ in range(4):
        pads, tq, i_bb, q_bb = _window_products(cfg, rng, 8)
        want = scan._correlate_gather(cfg, pads, tq, i_bb, q_bb)
        got = rank_order_correlate(cfg, pads, tq, i_bb, q_bb, kn)
        for a, b in zip(got, want):
            a, b = a.numpy(), b.numpy()
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all()
            n_sums += a.size
            n_equal += int((a == b).sum())
    with capsys.disabled():
        print(f"\n  kN={kn}: {n_equal} of {n_sums} float32 sums bit-equal, the rest within "
              "one ulp")
    assert n_sums == 4 * 8 * 6 and n_equal >= n_sums - 2


# --- (d) the plain path at every size ---------------------------------------


def _block_inputs():
    """(frames-route arguments, fused-route arguments) of one 6-ms block,
    3 channels at the fast front end, the last one idle."""
    cfg = sgt.fast_config(number_of_channels=3, track_block_ms=8)
    r = 6
    inp = channel_inputs(cfg, r + 3, "cpu", n_idle=1)
    start_w = torch.div(inp.state.ptr - cfg.track_frame_pre, 4, rounding_mode="floor")
    frames = mk.build_frames_plain(inp.words, start_w, r, cfg.track_window // 4,
                                   cfg.samples_per_code // 4)
    tail = (inp.state, inp.code_pads, inp.carr_basis, inp.active, cfg, r)
    return (frames, 4 * start_w, *tail), (inp.words, start_w, *tail)


def _leaves(out):
    st, ys, ovf = out
    return [*st, *ys, ovf]


@pytest.mark.parametrize("kn", mk.CLUSTER_SIZES)
def test_plain_path_counts_no_launches_at_any_size(kn):
    """CPU tensors take the plain versions at every forced cluster size:
    no launch is counted, no size is recorded as launched, and the results
    are those of the default size."""
    args, fargs = _block_inputs()
    wrappers = (mk.track_block, mk.track_block_fused, s2.track_block_stage)
    before = [(f.launches, f.ctas_per_channel) for f in wrappers]
    block = functools.partial(mk.track_block, ctas_per_channel=kn, threads_per_cta=128)
    for a, b in zip(_leaves(block(*args)), _leaves(mk.track_block(*args))):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(mk.track_block_fused(*fargs, ctas_per_channel=kn)),
                    _leaves(mk.track_block_fused(*fargs))):
        assert torch.equal(a, b)
    s2.track_block_stage("carrier", *args, ctas_per_channel=kn)
    assert [(f.launches, f.ctas_per_channel) for f in wrappers] == before


def test_plain_path_refuses_a_size_the_kernel_lacks():
    args, _ = _block_inputs()
    with pytest.raises(ValueError, match="ctas_per_channel=3"):
        mk.track_block(*args, ctas_per_channel=3)
    with pytest.raises(ValueError, match="threads_per_cta=1000"):
        s2.track_block_stage("full", *args, threads_per_cta=1000)
