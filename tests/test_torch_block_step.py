"""The block tracker's segment loop on the stacked state
(``scan.track_segments``): on the CPU every segment runs the step eagerly,
the full blocks placing their outputs at the block counter kept on the
device, and the result is bit-equal to the loop it replaced, which tracked
segment by segment on TrackState and joined the parts with ``torch.cat``.
No graph is captured on the CPU.  The graph route itself is held to this
eager route on the card (tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.acquire.search import Channels
from softgnss_tpu_torch.signals.synth import SatelliteSignal, synthesize_signal
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import scan

torch.set_num_threads(1)


def replaced_loop(config, words, state, code_pads, carr_basis, active, n_ms, start_ms,
                  build, block):
    """The segment loop before the stacked step: each segment a call of
    ``block`` on TrackState, the parts joined at the end."""
    spc_w = config.samples_per_code // 4
    win_w = config.track_window // 4
    pre = config.track_frame_pre
    B = max(1, config.track_block_ms)
    phase = start_ms % B
    lead = min(B - phase, n_ms) if phase else 0
    n_full = (n_ms - lead) // B
    r_tail = n_ms - lead - n_full * B

    def segment(st, base, p0, r):
        start_w = torch.div(base, 4, rounding_mode="floor") + p0 * spc_w
        any_act = torch.where(active, start_w, 0).max()
        start_w = torch.where(active, start_w, any_act)
        if build is None:
            return block(words, start_w, st, code_pads, carr_basis, active, config, r)
        frames = build(words, start_w, r, win_w, spc_w)
        return block(frames, 4 * start_w, st, code_pads, carr_basis, active, config, r)

    st, parts, ovfs = state, [], []
    plan = ([("lead", phase, lead)] if lead else []) + [("block", 0, B)] * n_full \
        + ([("block", 0, r_tail)] if r_tail else [])
    for kind, p0, r in plan:
        if kind == "lead":
            base = st.block_base
        else:
            base = st.ptr - pre
            st = st._replace(block_base=base)
        st, ys, ovf = segment(st, base, p0, r)
        parts.append(ys)
        ovfs.append(ovf)
    ys = scan.MsOutputs(*[torch.cat(leaf) for leaf in zip(*parts)])
    return st, ys, torch.stack(ovfs).amax(0)


@pytest.fixture(scope="module")
def capture():
    """Three satellites on four channels, the second idle; 16-ms blocks."""
    cfg = sgt.fast_config(number_of_channels=4, track_block_ms=16)
    sats = [SatelliteSignal(prn=p, doppler_hz=d, delay_samples=float(s), phase0=ph,
                            amplitude=2.0, nav_bits=(1, -1, -1, 1))
            for p, d, s, ph in ((5, 1200.0, 333, 0.4), (11, -2500.0, 1777, 2.1),
                                (20, 400.0, 40, 5.0))]
    sig = synthesize_signal(cfg, sats, 140, noise_std=4.0, seed=4, device="cpu")
    on = [sats[0], sats[1], sats[1], sats[2]]
    ch = Channels(prn=np.asarray([s.prn for s in on]),
                  acquired_freq=np.asarray([cfg.intermediate_freq + s.doppler_hz for s in on]),
                  code_phase=np.asarray([int(s.delay_samples) for s in on], np.int64),
                  status=["T", "-", "T", "T"])
    return cfg, sig, ch


ROUTES = {"B2 + B1": (mk.build_frames, mk.track_block),
          "plain": (mk.build_frames_plain, mk.track_block_plain),
          "fused": (None, mk.track_block_fused),
          "fused plain": (None, mk.track_block_fused_plain)}

#: (first call's ms, then the resumed call's ms): the segments each call
#: issues at 16-ms blocks in the comments
CALLS = [(37, 43),     # 2 full + a 5-ms tail; an 11-ms lead + 2 full
         (16, 8),      # 1 full; an 8-ms tail alone
         (9, 70),      # a tail alone; a 7-ms lead, 3 full, a 15-ms tail
         (64, 64)]     # 4 full; 4 full


def _run(loop, cfg, sig, ch, calls, build, block):
    words = scan.capture_words(sig)
    code_pads, carr_basis, active = scan.channel_tables(ch, sig.device)
    st, start, got = scan.initial_state(cfg, ch, sig.device), 0, []
    for n in calls:
        st, ys, ovf = loop(cfg, words, st, code_pads, carr_basis, active, n, start, build, block)
        got.append((st, ys, ovf))
        start += n
    return got


def _assert_equal(got, want):
    for (st, ys, ovf), (st0, ys0, ovf0) in zip(got, want):
        for name, a, b in [*zip(scan.TrackState._fields, st, st0),
                           *zip(scan.MsOutputs._fields, ys, ys0), ("overflow", ovf, ovf0)]:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), name


@pytest.mark.parametrize("calls", CALLS, ids=[f"{a}+{b}ms" for a, b in CALLS])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_step_is_bit_equal_to_the_loop_it_replaces(capture, route, calls):
    cfg, sig, ch = capture
    build, block = ROUTES[route]
    _assert_equal(_run(scan.track_segments, cfg, sig, ch, calls, build, block),
                  _run(replaced_loop, cfg, sig, ch, calls, build, block))


@pytest.mark.parametrize("opts", [{"pdi_ms": 4, "fll_bandwidth_hz": 10.0},
                                  {"track_block_ms": 5}], ids=["pdi4-fll", "5ms-blocks"])
def test_the_step_is_bit_equal_at_other_settings(capture, opts):
    cfg, sig, ch = capture
    cfg = cfg.with_options(**opts)
    _assert_equal(_run(scan.track_segments, cfg, sig, ch, (37, 43), *ROUTES["B2 + B1"]),
                  _run(replaced_loop, cfg, sig, ch, (37, 43), *ROUTES["B2 + B1"]))


def test_the_outputs_and_state_own_their_memory(capture):
    """The outputs of one call are not overwritten by the next, and a
    returned state is not the buffer the next call steps."""
    cfg, sig, ch = capture
    first = _run(scan.track_segments, cfg, sig, ch, (64,), *ROUTES["plain"])[0]
    kept = [v.clone() for v in (*first[0], *first[1], first[2])]
    _run(scan.track_segments, cfg, sig, ch, (64, 64), *ROUTES["plain"])
    for a, b in zip((*first[0], *first[1], first[2]), kept):
        assert torch.equal(a, b)


def test_the_kernel_entries_refuse_cpu_tensors(capture):
    """The stacked entries launch the kernels only: CPU tensors take the
    plain versions through the TrackState wrappers, never these."""
    cfg, sig, ch = capture
    code_pads, carr_basis, active = scan.channel_tables(ch, "cpu")
    state = scan.initial_state(cfg, ch)
    s_in = scan.stack_state(state, scan.new_stack(4, "cpu"))
    args = (s_in, scan.new_stack(4, "cpu"), scan.new_block_out(16, 4, "cpu"), code_pads,
            carr_basis, active, cfg, 16)
    frames = torch.zeros((16, 4, cfg.track_window // 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.track_block_stacked(frames, state.ptr, *args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.track_block_fused_stacked(scan.capture_words(sig), state.ptr // 4, *args)


def test_a_state_of_other_dtypes_is_refused(capture):
    """Stacking would cast a leaf silently: a resumed state of other dtypes
    raises, as the kernels' checks did before the state was stacked."""
    cfg, sig, ch = capture
    st = scan.initial_state(cfg, ch)
    with pytest.raises(ValueError, match="carr_freq"):
        scan.stack_state(st._replace(carr_freq=st.carr_freq.float()), scan.new_stack(4, "cpu"))
    with pytest.raises(ValueError, match="carr_phase"):
        scan.track_segments(cfg, scan.capture_words(sig),
                            st._replace(carr_phase=st.carr_phase.long()),
                            *scan.channel_tables(ch, "cpu"), 16, 0, *ROUTES["plain"])


def test_a_state_round_trips_through_its_stack(capture):
    cfg, _, ch = capture
    st = scan.initial_state(cfg, ch)
    st = st._replace(carr_phase=torch.tensor([-2**31, -1, 0, 2**31 - 1], dtype=torch.int32),
                     acc_q_l=torch.tensor([0.5, -1.0, 3.0, 7.0]))
    back = scan.unstack_state(scan.stack_state(st, scan.new_stack(4, "cpu")), st.block_base)
    for name, a, b in zip(scan.TrackState._fields, back, st):
        assert a.dtype == b.dtype and torch.equal(a, b), name
