"""B2, the frames builder's bulk design, without the card: its launch plan
(megakernel.frames_plan) and its walk (megakernel.frames_walk, the index
arithmetic of csrc/build_frames.cu's build_frames_bulk_kernel), replayed in
NumPy over a capture laid out on a 16-byte grid, against
megakernel.build_frames_plain; every frame word written exactly once, every
copy 16-byte aligned, inside the buffer and inside the capture's lines, and
no write reading a part not yet staged.  This file imports only numpy,
torch and softgnss_tpu_torch, so it also runs on the card's machine, where
its ``gpu`` tests hold the kernel itself against the plain version:
    python -m pytest --noconftest -m gpu tests/test_torch_frames.py
"""

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.scripts import builder_time as s3
from softgnss_tpu_torch.track import cuda_lib
from softgnss_tpu_torch.track import megakernel as mk

torch.set_num_threads(1)

#: a word no capture of these tests holds: the grid's padding and the
#: buffer's words before a copy lands
SENTINEL = -0x5A5A5A5B


def _replay(plan, cap: np.ndarray, starts, lead: int, r: int, win_w: int, spc_w: int):
    """The frames the kernel writes at ``plan``, by walking frames_walk:
    the capture sits ``lead`` words past a 16-byte boundary of a grid
    padded with SENTINEL; per CTA a buffer of plan.buf_w words, each step's
    copies landing in it before that step's writes read it, as the kernel
    does (int4s from the two aligned int4s at the shift, head, tail and
    the words outside the capture one by one).  Returns (frames, writes per
    word, units)."""
    n, n_ch = cap.shape[0], len(starts)
    grid = np.full(lead + n + 8, SENTINEL, np.int64)
    grid[lead:lead + n] = cap
    frames = np.full(r * n_ch * win_w, SENTINEL, np.int64)
    count = np.zeros(r * n_ch * win_w, np.int64)
    units = mk.frames_walk(plan, starts, n, lead, r, win_w, spc_w)
    assert [(u.j, u.g) for u in units] == [(j, g) for j in range(r) for g in range(plan.groups)]
    for u in units:
        buf = np.full(plan.buf_w, SENTINEL, np.int64)
        steps = sorted({c.step for c in u.copies} | {w.step for w in u.writes})
        assert len({c.off for c in u.copies}) == len(u.copies) or not u.hull
        for step in steps:
            for c in (c for c in u.copies if c.step == step):
                g0 = lead + c.copy_w                       # the copy's first grid word
                assert g0 >= 0 and g0 % 4 == 0 and c.bytes % 16 == 0 and c.bytes > 0
                assert c.off % 4 == 0 and c.off + c.bytes // 4 <= plan.buf_w
                lines = np.arange(g0, g0 + c.bytes // 4, 4)
                # every 16-byte line holds a capture word: the copy stays
                # inside the capture's allocation
                assert np.all(lines + 3 >= lead) and np.all(lines < lead + n)
                buf[c.off:c.off + c.bytes // 4] = grid[g0:g0 + c.bytes // 4]
            for w in (w for w in u.writes if w.step == step):
                sd = int(starts[w.d]) + u.j * spc_w + u.g_lo      # source of column g_lo
                dst = (u.j * n_ch + w.d) * win_w + u.g_lo
                assert w.head + 4 * w.n4 + w.tail == u.g_hi - u.g_lo
                assert 0 <= w.head < 4 and 0 <= w.tail < 4

                def word(s):
                    return buf[w.off + s - w.v0 + w.lead] if w.v0 <= s < w.v1 else 0

                for i in (*range(w.head), *range(w.head + 4 * w.n4, u.g_hi - u.g_lo)):
                    frames[dst + i] = word(sd + i)
                    count[dst + i] += 1
                if w.n4:
                    assert (dst + w.head) % 4 == 0                  # st.global.v4 aligned
                    q = np.arange(w.n4)
                    s = sd + w.head + 4 * q
                    fast = (s >= w.v0) & (s + 4 <= w.v1)
                    o = s[fast] - w.v0 + w.lead
                    assert np.all(o % 4 == w.sh)
                    x = w.off + (o // 4) * 4                        # the aligned int4 at o
                    assert np.all(x + 4 + 4 * (w.sh > 0) <= plan.buf_w)
                    quads = np.empty((w.n4, 4), np.int64)
                    quads[fast] = buf[x[:, None] + w.sh + np.arange(4)]
                    quads[~fast] = np.array([[word(si + k) for k in range(4)] for si in s[~fast]],
                                            np.int64).reshape(-1, 4)
                    cols = dst + w.head + 4 * q[:, None] + np.arange(4)
                    frames[cols] = quads
                    count[cols] += 1
    return frames.reshape(r, n_ch, win_w), count.reshape(r, n_ch, win_w), units


def _inputs(r: int, n_ch: int, win_w: int, spc_w: int, seed: int, spread: int | None = None):
    """A capture and starts with channel 0's frames before the capture
    start, channel 1's last frames past its end (both within a code period
    and a quarter of the rest), two channels on one start (an idle channel on an
    active one's span), the rest spread over ``spread`` words (default one
    code period)."""
    rng = np.random.default_rng(seed)
    n = r * spc_w + win_w
    cap = rng.integers(-2**31, 2**31, n).astype(np.int64)
    starts = rng.integers(0, spread or spc_w, n_ch)
    if n_ch > 1:                    # a tenth of a window out at both ends
        starts[0] = -(win_w // 10) - 1
        starts[1] = n - (r - 1) * spc_w - win_w + win_w // 10 + 1
    if n_ch > 3:
        starts[3] = starts[2]
    return cap, starts.astype(np.int64)


def _plain(cap, starts, r, win_w, spc_w) -> np.ndarray:
    return mk.build_frames_plain(torch.from_numpy(cap.astype(np.int32)), torch.from_numpy(starts),
                                 r, win_w, spc_w).numpy()


def _grouped(plan, win_w: int, group_w: int, buf_w: int | None = None):
    """``plan`` with its window cut into columns of ``group_w`` words (and
    a buffer of ``buf_w`` words)."""
    return plan._replace(group_w=group_w, groups=-(-win_w // group_w),
                         buf_w=plan.buf_w if buf_w is None else buf_w)


@pytest.mark.parametrize("union", [True, False], ids=["union", "per-channel"])
@pytest.mark.parametrize("lead", [0, 1, 2, 3], ids=lambda v: f"lead{4 * v}")
@pytest.mark.parametrize("r, n_ch", [(1, 1), (5, 8), (64, 12), (5, 12), (64, 1), (1, 8)])
def test_walk_reproduces_the_plain_frames(r, n_ch, lead, union):
    """At every win_w % 4 and capture lead, in one column group and in
    several (of 10 words, the last one narrower), with parts of 16 words,
    the replayed walk gives the plain frames bit for bit and writes each
    frame word exactly once."""
    for k, win_w in enumerate((36, 37, 38, 39)):
        spc_w = win_w - 3 - k                       # windows overlap the next ms's
        cap, starts = _inputs(r, n_ch, win_w, spc_w, 100 * r + 10 * n_ch + k)
        plan = mk.frames_plan(r, n_ch, win_w, spc_w, union=union, part_w=16, n_sm=4,
                              spread_w=8 * spc_w * (r + 1))
        assert plan.groups == 1
        for group_w in (win_w, 10):
            got, count, units = _replay(_grouped(plan, win_w, group_w), cap, starts, lead, r,
                                        win_w, spc_w)
            np.testing.assert_array_equal(got, _plain(cap, starts, r, win_w, spc_w))
            assert np.all(count == 1), f"win_w={win_w}: words written {np.unique(count)} times"
            assert all(u.hull == union for u in units)


@pytest.mark.parametrize("buf_w", [24, 36, 64], ids=lambda v: f"buf{v}")
def test_a_hull_past_the_buffer_takes_the_channels_in_rounds(buf_w):
    """Starts further apart than the buffer holds: each channel's columns
    staged on their own, as many per round as the buffer holds, still the
    plain frames with each word once."""
    r, n_ch, win_w, spc_w = 5, 8, 37, 34
    cap, starts = _inputs(r, n_ch, win_w, spc_w, 5, spread=40 * spc_w)
    plan = _grouped(mk.frames_plan(r, n_ch, win_w, spc_w, part_w=16, n_sm=4), win_w, 10, buf_w)
    got, count, units = _replay(plan, cap, starts, 2, r, win_w, spc_w)
    np.testing.assert_array_equal(got, _plain(cap, starts, r, win_w, spc_w))
    assert np.all(count == 1)
    for u in units:
        per_round = buf_w // (-(-(u.g_hi - u.g_lo + 8) // 4) * 4)
        assert not u.hull and per_round >= 1
        assert max(w.step for w in u.writes) == -(-n_ch // per_round) - 1


def _giove16():
    """The front end of SoftGNSS's second data set: fs 16.3676 MHz, IF
    4.1304 MHz (gnss_bench/configs/giove16.json)."""
    return sgt.default_config(sampling_freq=16_367_600.0, intermediate_freq=4_130_400.0)


@pytest.mark.parametrize("union", [True, False], ids=["union", "per-channel"])
@pytest.mark.parametrize("name", ["default", "fast", "giove16"])
def test_walk_at_the_receivers_geometry(name, union):
    """One 64-ms block of 8 channels at the reference (9 580-word windows),
    the fast front end (1 033 words: not whole int4s) and the 16.3676-MHz
    one (4 110 words, 4 092 a ms) at the default plan, a capture 4 bytes
    past a 16-byte boundary: the plain frames,
    each word once; with union every CTA stages the hull of its columns
    once, in parts of about part_w words laid end to end, without it each
    channel's columns.  Words are written one by one (a scalar head or
    tail) in exactly the frames that ragged_rows counts: none at the
    reference, every frame at the other two."""
    cfg = {"default": sgt.default_config, "fast": sgt.fast_config,
           "giove16": _giove16}[name]()
    r, n_ch = 64, 8
    win_w, spc_w = cfg.track_window // 4, cfg.samples_per_code // 4
    cap, starts = _inputs(r, n_ch, win_w, spc_w, 7)
    plan = mk.frames_plan(r, n_ch, win_w, spc_w, union=union)
    assert plan.groups == (1 if name == "fast" else 2)
    got, count, units = _replay(plan, cap, starts, 1, r, win_w, spc_w)
    np.testing.assert_array_equal(got, _plain(cap, starts, r, win_w, spc_w))
    assert np.all(count == 1)
    ragged = {u.j * n_ch + w.d for u in units for w in u.writes if w.head or w.tail}
    assert len(ragged) == mk.ragged_rows(0, r * n_ch, win_w)
    assert len(ragged) == (0 if name == "default" else r * n_ch)
    for u in units:
        assert u.hull == union
        h_lo = starts.min() + u.j * spc_w + u.g_lo
        h_hi = starts.max() + u.j * spc_w + u.g_hi
        held = max(0, min(h_hi, cap.shape[0]) - max(h_lo, 0))
        staged = sum(c.bytes for c in u.copies) // 4
        if union:                    # the hull once: aligned, parts end to end
            assert held <= staged <= held + 6 and len(u.copies) <= mk.MAX_PARTS
            assert [c.off for c in u.copies] == [c.copy_w - u.copies[0].copy_w for c in u.copies]
            assert all(c.bytes <= 4 * plan.part_w + 16 for c in u.copies[:-1])
        else:
            assert len(u.copies) <= n_ch and staged >= sum(
                max(0, min(s + u.j * spc_w + u.g_hi, cap.shape[0]) - max(s + u.j * spc_w + u.g_lo,
                                                                          0)) for s in starts)


def test_frames_plan_at_the_reference_geometry():
    """Column groups of whole int4s, no narrower than MIN_GROUP_W words,
    about ctas_per_sm CTAs per SM over the block; the buffer holds a
    group's hull of starts a code period and a quarter apart (union) or
    every channel's columns of a group."""
    plan = mk.frames_plan(64, 8, 9580, 9548)
    assert plan == mk.FramesPlan(True, 2, 4792, 4 * ((9548 + 9548 // 4 + 4792 + 8 + 3) // 4),
                                 mk.FRAMES_PART_W, mk.FRAMES_THREADS,
                                 4 * plan.buf_w + 8 * mk.MAX_PARTS + 8 * 8)
    assert round(mk.FRAMES_CTAS_PER_SM * mk.SMS / 64) == plan.groups
    apart = mk.frames_plan(64, 8, 9580, 9548, union=False)
    assert apart.buf_w == 8 * (4792 + 8) and apart.smem_bytes == mk.frames_smem(8, apart.buf_w)
    for r, n_sm, per_sm, win_w, groups in ((64, 132, 8, 9580, 9), (8, 132, 1, 9580, 9),
                                           (1, 132, 1, 9580, 9), (64, 114, 2, 9580, 4),
                                           (37, 132, 1, 9580, 4), (64, 132, 1, 1033, 1),
                                           (64, 132, 1, 100, 1), (2000, 132, 1, 9580, 1)):
        p = mk.frames_plan(r, 12, win_w, win_w - 32, ctas_per_sm=per_sm, n_sm=n_sm)
        assert p.groups == groups and p.groups == -(-win_w // p.group_w), (r, win_w)
        assert p.group_w % 4 == 0 and (p.group_w >= mk.MIN_GROUP_W or p.groups == 1)
        assert p.buf_w % 4 == 0 and p.buf_w >= p.group_w + 8 and p.smem_bytes <= mk.MAX_SMEM
    # a hull wider than a CTA's shared memory: the buffer is cut to it
    wide = mk.frames_plan(64, 8, 9580, 9548, spread_w=10**6)
    assert wide.smem_bytes <= mk.MAX_SMEM < wide.smem_bytes + 16


@pytest.mark.parametrize("kwargs, match", [
    (dict(r=0), "empty shape"), (dict(n_ch=0), "empty shape"), (dict(win_w=0), "empty shape"),
    (dict(r=65_536), "at most"), (dict(part_w=8), "part_w"),
    (dict(threads=48), "threads"), (dict(threads=2048), "threads"),
    (dict(ctas_per_sm=0), "ctas_per_sm"),
    (dict(n_ch=30_000), "shared memory"), (dict(win_w=60_000, ctas_per_sm=0.01), "shared memory"),
], ids=lambda v: str(v) if isinstance(v, str) else "-".join(f"{k}{x}" for k, x in v.items()))
def test_frames_plan_refuses_shapes_past_its_limits(kwargs, match):
    args = dict(r=64, n_ch=8, win_w=9580, spc_w=9548) | kwargs
    with pytest.raises(ValueError, match=match):
        mk.frames_plan(args.pop("r"), args.pop("n_ch"), args.pop("win_w"), args.pop("spc_w"),
                       **args)


def test_frames_plan_takes_the_widest_group_that_fits():
    """One channel's columns of a group fill a CTA's shared memory at most
    (MAX_SMEM inclusive)."""
    room = (mk.MAX_SMEM - mk.frames_smem(1, 0)) // 16 * 4
    plan = mk.frames_plan(1, 1, room - 8, 16, ctas_per_sm=0.01)
    assert plan.groups == 1 and plan.buf_w == room and plan.smem_bytes <= mk.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        mk.frames_plan(1, 1, room - 7, 16, ctas_per_sm=0.01)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    """On CPU tensors B2 and S3's vec4 variant run the plain version (a
    plan is ignored) and count no launch."""
    args = s3.frame_args(3, 4, "cpu", edges=True, lead=3)
    before = (mk.build_frames.launches, s3.build_frames_vec4.launches)
    want = mk.build_frames_plain(*args)
    plan = mk.frames_plan(4, 3, args[3], args[4], union=False)
    assert torch.equal(mk.build_frames(*args), want)
    assert torch.equal(mk.build_frames(*args, plan=plan), want)
    assert torch.equal(s3.build_frames_vec4(*args), want)
    assert (mk.build_frames.launches, s3.build_frames_vec4.launches) == before


@pytest.mark.parametrize("base, rows, win_w, want", [
    (0, 512, 9580, 0), (512, 512, 9580, 0), (0, 512, 4110, 512), (0, 1, 4110, 1),
    (0, 4, 1033, 4), (0, 3, 4, 0), (8, 3, 4, 3), (4, 2, 3, 2)],
    ids=["ref38", "ref38_at_512", "giove16", "giove16_one", "fast", "whole_int4s",
         "base_off_a_line", "base_and_rows_off"])
def test_ragged_rows_counts_the_frames_off_a_line(base, rows, win_w, want):
    """A frame is ragged when its first or its end byte is off a 16-byte
    line: at 4 110 words every frame is (one starts on a line and ends 8
    bytes past one, the next the other way round); at 9 580 none is.  A
    frame whose bytes are not whole lines leaves every frame ragged."""
    assert mk.ragged_rows(base, rows, win_w) == want


def test_s3_frame_args_keep_the_words_at_every_lead():
    """builder_time's capture view at word offsets 0-3 of its allocation:
    the same words and starts at every lead, the starts within one code
    period but at the edges."""
    base = s3.frame_args(8, 2, "cpu", edges=True)
    for lead in s3.LEADS:
        args = s3.frame_args(8, 2, "cpu", edges=True, lead=lead)
        assert args[0].storage_offset() == lead and torch.equal(args[0], base[0])
        assert torch.equal(args[1], base[1]) and args[2:] == base[2:]
    inner = s3.frame_args(12, 2, "cpu")[1]
    assert int(inner.min()) >= 0 and int(inner.max()) < base[4]
    cases = s3.check_cases()
    assert {c[4] for c in cases} == set(s3.LEADS) and {c[2] for c in cases} == {64, 1, 8}


def test_a_failed_build_raises_with_no_fallback(monkeypatch):
    """A tensor not on the CPU never takes the plain version: when the
    library does not build, build_frames raises."""
    def broken(name, sources):
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(cuda_lib, "load_library", broken)
    cap = torch.empty(100, dtype=torch.int32, device="meta")
    starts = torch.empty(2, dtype=torch.int64, device="meta")
    plan = mk.frames_plan(2, 2, 8, 5)
    before = mk.build_frames.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        mk.build_frames(cap, starts, 2, 8, 5, plan=plan)
    assert mk.build_frames.launches == before


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (B2 is also checked by chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("union", [True, False], ids=["union", "per-channel"])
@pytest.mark.parametrize("lead", [0, 1, 2, 3], ids=lambda v: f"lead{4 * v}")
def test_bulk_kernel_matches_plain_on_card(cuda_device, lead, union):
    """The bulk kernel bit-equal to the plain version at r = 64, 1 and 8,
    C = 1, 8 and 12, the reference, the fast and the 16.3676-MHz geometry
    (every frame on whole 16-byte lines at the first, none at the other
    two: ragged_rows), frames past both capture ends, small parts (many per hull), one
    and many column groups, a buffer too small for the hull (rounds), one
    wide enough for the edge starts and the default plan."""
    for cfg in (sgt.default_config(), sgt.fast_config(), _giove16()):
        for r, n_ch in ((64, 8), (1, 12), (8, 1), (8, 12)):
            args = s3.frame_args(n_ch, r, cuda_device, edges=n_ch > 1, lead=lead, config=cfg)
            want = mk.build_frames_plain(*args)
            for part_w, per_sm, spread_w in ((16, 1, None), (100, 4, None), (2048, 1, None),
                                             (2048, 8, 0), (mk.FRAMES_PART_W, 2, None),
                                             (mk.FRAMES_PART_W, 2, 4 * args[4])):
                plan = mk.frames_plan(r, n_ch, args[3], args[4], union=union, part_w=part_w,
                                      ctas_per_sm=per_sm, spread_w=spread_w,
                                      n_sm=cuda_lib.sm_count(0))
                assert torch.equal(mk.build_frames(*args, plan=plan), want), (r, n_ch, plan)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_refused_bulk_launch_raises_on_card(cuda_device):
    """A plan past the kernel's limits is refused by the C entry and the
    wrapper raises; it never falls back to another design or the plain
    version."""
    args = s3.frame_args(8, 4, cuda_device)
    plan = mk.frames_plan(4, 8, args[3], args[4])
    before = mk.build_frames.launches
    with pytest.raises(RuntimeError, match="build_frames launch failed"):
        mk.build_frames(*args, plan=plan._replace(smem_bytes=plan.smem_bytes - 4))
    with pytest.raises(RuntimeError, match="build_frames launch failed"):
        mk.build_frames(*args, plan=plan._replace(buf_w=plan.group_w, smem_bytes=mk.MAX_SMEM))
    assert mk.build_frames.launches == before
    assert torch.equal(mk.build_frames(*args), mk.build_frames_plain(*args))
    assert mk.build_frames.launches == before + 1
    torch.cuda.synchronize()
