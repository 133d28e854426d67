"""What decides ``correct``: the judged jobs' outputs against the plain
reference (``reference``) and the generator's truth (``generator.Scene``).

Every number compared has its limit in the configuration's ``limits``
table; PERF.md gives the readings each limit was set from.

* ``acq_mismatch`` (limit 0): PRNs whose acquired flag differs from the
  reference's float64 search, acquired PRNs whose code phase, Doppler bin
  or fine frequency differ, channels whose PRN, frequency or code phase
  differ from the reference's assignment.
* ``sample_mismatch`` (limit 0): (ms, channel) pairs whose pointer after
  the ms differs from the reference's code NCO walk.
* ``status_mismatch`` (limit 0): channels whose lock verdict (tracking, or
  demoted for lost lock) differs from the receiver's lock rule applied to
  the reference's correlators.
* ``truth_mismatch`` (limit 0): channels the receiver reports as tracking
  that hold a PRN that was not injected, whose last code-period start
  lies more than half a chip from the synthesized one, or whose carrier
  over the last second has a median more than ``TRUTH_CARRIER_HZ`` from
  the synthesized carrier; and injected satellites on no channel reported
  as tracking.  One exception: a satellite on a demoted channel where the
  reference's float64 closed loop, started from the acquisition that
  ``acq_mismatch`` holds equal to the receiver's, fails the lock rule over
  its first ``WITNESS_MS`` ms as well (``reference.holds_lock``): no
  receiver of this specification locks it.  Each such satellite is named
  on standard error.
* ``corr_rel``: the largest gap between a judged and a reference
  correlator, over every ms and the six correlators of every active
  channel, as a share of the channel's RMS prompt magnitude or of the
  channels' median one, whichever is larger (a demoted channel's own is
  noise).
* ``carr_freq_hz``, ``code_freq_hz``: the largest gap, Hz, over every ms
  of every active channel, demoted or not, between the judged loop
  filters' outputs (the carrier or code frequency and the filter's
  accumulator) and the reference's loop update fed the judged run's own
  correlators of that ms and its filter memory of the ms before.  With
  ``corr_rel`` and ``sample_mismatch`` this holds every step of the closed
  loop: the NCOs walk at the frequencies the filters gave, the
  correlators are those of that walk, and the frequencies follow from the
  correlators.  Fed the same inputs, the discriminator's atan(Q/I) cannot
  turn rounding into a large gap where the prompt passes near zero.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from gnss_bench import reference as ref
from gnss_bench.generator import Scene

#: a locked PLL's carrier over 1 s sits within a few tenths of a Hz of
#: the synthesized one; 5 Hz is a loop that has slipped or lost lock
TRUTH_CARRIER_HZ = 5.0
#: ms of the float64 closed loop that witnesses a satellite no loop locks
WITNESS_MS = 4000
TRACK_KEYS = ("absolute_sample", "carr_freq", "code_freq", "i_e", "i_p", "i_l", "q_e", "q_p",
              "q_l", "pll_discr", "pll_discr_filt", "dll_discr", "dll_discr_filt")
#: the order of the numbers in the result's ``checks``
CHECKS = ("acq_mismatch", "sample_mismatch", "status_mismatch", "truth_mismatch", "corr_rel",
          "carr_freq_hz", "code_freq_hz")


def fingerprint(out: dict) -> str:
    """A digest of every array of a job's outputs (equal outputs, equal digest)."""
    h = hashlib.sha256()
    for key in sorted(out):
        v = out[key]
        h.update(key.encode())
        h.update(np.ascontiguousarray(np.asarray(v)).tobytes() if not isinstance(v, list)
                 else repr(v).encode())
    return h.hexdigest()


def acquisition_mismatch(rx: ref.Receiver, want: ref.Acquisition, out: dict) -> int:
    got = out["acq_carr_freq"] > 0
    bad = int((got != want.acquired).sum())
    both = got & want.acquired
    bad += int((out["acq_code_phase"][both] != want.code_phase[both]).sum())
    bad += int((out["acq_doppler_bin"][both] != want.doppler_bin[both]).sum())
    bad += int((np.abs(out["acq_carr_freq"][both] - want.carr_freq[both]) > 1e-3).sum())
    prn, freq, phase = ref.assign(rx, want)
    bad += int((out["prn"] != prn).sum())
    same = out["prn"] == prn
    bad += int((np.abs(out["acquired_freq"] - freq)[same] > 1e-3).sum())
    bad += int((out["code_phase"] != phase)[same].sum())
    return bad


def truth_mismatch(rx: ref.Receiver, scene: Scene, capture: torch.Tensor,
                   want: ref.Acquisition, out: dict) -> tuple[int, list[str]]:
    """The count, and a line for each channel or satellite at fault, not
    tracked or witnessed."""
    injected = {int(p): i for i, p in enumerate(scene.prn)}
    half_chip = 0.5 * rx.sampling_freq / rx.code_freq_basis
    carrier = scene.carrier_hz()
    last = min(1000, out["carr_freq"].shape[1])
    bad, why = 0, []
    tracked = set()
    for c, status in enumerate(out["status"]):
        if status == "-":
            continue
        prn = int(out["prn"][c])
        i = injected.get(prn)
        if i is None:
            why.append(f"channel {c} PRN {prn}, not injected: status {status}")
            bad += status == "T"
            continue
        off = float(scene.boundary_offset(i, np.asarray(out["absolute_sample"][c, -1])))
        df = float(np.median(out["carr_freq"][c, -last:]) - carrier[i])
        n = int(abs(off) > half_chip) + int(abs(df) > TRUTH_CARRIER_HZ)
        if n or status != "T":
            why.append(f"channel {c} PRN {prn}: status {status}, last code period {off:.2f} "
                       f"samples from the truth, carrier {df:.3f} Hz from it (Doppler "
                       f"{scene.doppler_hz[i]:.1f} Hz, acquired "
                       f"{out['acquired_freq'][c] - carrier[i]:+.1f} Hz from it)")
        if status == "T":
            bad += n
            tracked.add(prn)
    rprn, rfreq, rphase = ref.assign(rx, want)
    for prn in sorted(set(injected) - tracked):
        on = np.flatnonzero(rprn == prn)
        if not on.size:
            why.append(f"PRN {prn} injected, on no channel")
            bad += 1
            continue
        c = int(on[0])
        n_ms = min(WITNESS_MS, rx.ms_to_process)
        held = bool(ref.holds_lock(rx, capture, rprn[on], rfreq[on], rphase[on], n_ms)[0])
        why.append(f"PRN {prn} injected, not tracked: the float64 reference loop from the "
                   f"same acquisition {'holds' if held else 'fails'} the lock rule over "
                   f"{n_ms} ms (witness, channel {c})")
        bad += held
    return bad, why


def loop_gaps(rx: ref.Receiver, out: dict, chans: list[int]) -> tuple[float, float]:
    """(carr_freq_hz, code_freq_hz): the judged loop filters' outputs against
    the reference's loop update fed the judged correlators and memory."""
    corr = np.stack([np.asarray(out[k][chans], np.float64) for k in ref._CORR], -1)
    before = lambda key: np.concatenate(                      # noqa: E731
        [np.zeros((len(chans), 1)), np.asarray(out[key][chans], np.float64)[:, :-1]], 1)
    prev = {"carr_nco": before("pll_discr_filt"), "carr_err": before("pll_discr"),
            "code_nco": before("dll_discr_filt"), "code_err": before("dll_discr")}
    basis = np.asarray(out["acquired_freq"][chans], np.float64)[:, None]
    mem, carr, code = ref.loop_filters(rx, corr, basis, prev)
    gap = lambda a, key: float(np.abs(a - out[key][chans]).max())  # noqa: E731
    return (max(gap(carr, "carr_freq"), gap(mem["carr_nco"], "pll_discr_filt")),
            max(gap(code, "code_freq"), gap(mem["code_nco"], "dll_discr_filt")))


def tracking_gaps(rx: ref.Receiver, capture: torch.Tensor, want: ref.Acquisition,
                  out: dict, block_ms: int) -> dict:
    """sample_mismatch, status_mismatch, corr_rel, carr_freq_hz and
    code_freq_hz of one job's tracking, over every active channel."""
    rprn, rfreq, rphase = ref.assign(rx, want)
    chans = [c for c, s in enumerate(out["status"]) if s != "-"]
    if not chans:
        return {"sample_mismatch": 0, "status_mismatch": 0, "corr_rel": float("inf"),
                "carr_freq_hz": float("inf"), "code_freq_hz": float("inf")}
    prn = out["prn"][chans]
    basis = np.where(rprn[chans] == prn, rfreq[chans], out["acquired_freq"][chans])
    ptr0 = np.where(rprn[chans] == prn, rphase[chans], out["code_phase"][chans])
    judged = {k: out[k][chans] for k in TRACK_KEYS}
    r = ref.track_step(rx, capture, prn, basis, ptr0, judged, block_ms=block_ms)
    lost = ref.lock_lost(rx, r["i_p"], r["q_p"])
    status = np.array([out["status"][c] for c in chans])
    rms = np.sqrt(np.mean(r["i_p"] ** 2 + r["q_p"] ** 2, axis=1))
    gap = np.max([np.abs(judged[k] - r[k]).max(axis=1) for k in ref._CORR], axis=0)
    carr, code = loop_gaps(rx, out, chans)
    return {"sample_mismatch": int((judged["absolute_sample"] != r["absolute_sample"]).sum()),
            "status_mismatch": int((lost != (status == "L")).sum()),
            "corr_rel": float(np.max(gap / np.maximum(rms, np.median(rms)))),
            "carr_freq_hz": carr, "code_freq_hz": code}


def judge(rx: ref.Receiver, judged: list[tuple[Scene, torch.Tensor, list[dict]]],
          block_ms: int = 128) -> tuple[dict, int, list[str]]:
    """The worst of each number over the judged jobs' outputs, given as
    (scene, capture, outputs of jobs on that capture); each distinct output
    is judged once.  Returns (numbers, number of distinct outputs, a line
    for each satellite or channel the truth check names)."""
    worst: dict = {}
    why: list[str] = []
    n_distinct = 0
    for scene, capture, outputs in judged:
        want = ref.acquire(rx, capture)
        distinct = {fingerprint(o): o for o in outputs}
        n_distinct += len(distinct)
        for out in distinct.values():
            truth, lines = truth_mismatch(rx, scene, capture, want, out)
            why += [f"capture {scene.index}: {line}" for line in lines]
            nums = {"acq_mismatch": acquisition_mismatch(rx, want, out), "truth_mismatch": truth}
            nums.update(tracking_gaps(rx, capture, want, out, block_ms))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
    if not worst:
        return {k: float("inf") for k in CHECKS}, 0, ["no job was judged"]
    return {k: worst[k] for k in CHECKS}, n_distinct, why


def passes(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k] for k in CHECKS)
