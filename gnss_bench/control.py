"""The readings each limit is set from, and the control that has to fail.

    python3 -m gnss_bench.control --workload ref38.obs --seeds 11 12 13 --control 11 12 13

For every seed of ``--seeds``: each of the cell's captures, one job of the
program on it as the window runs it (the capture kept where the mix keeps
it, the route the mix takes), and the judge's numbers (the lower
readings).  For every seed of ``--control``: the control on each capture,
the reference's whole tracker (``reference.track_closed_loop``) in
float32, one precision below the float64 the configuration states, put in
the program's place from the reference's own acquisition and channels,
judged the same way (the upper readings).  One JSON line per capture; not
run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gnss_bench import generator, judge, reference, registry
from gnss_bench.run import held, job_options, outputs_of, receiver_config


def control_outputs(rx: reference.Receiver, capture: torch.Tensor, dtype=torch.float32) -> dict:
    """The control's outputs in the judge's format."""
    acq = reference.acquire(rx, capture)
    prn, freq, phase = reference.assign(rx, acq)
    act = prn > 0
    trk = reference.track_closed_loop(rx, capture, prn[act], freq[act], phase[act],
                                      rx.ms_to_process, dtype=dtype)
    lost = iter(reference.lock_lost(rx, trk["i_p"], trk["q_p"]))
    out = {"acq_carr_freq": acq.carr_freq, "acq_code_phase": acq.code_phase,
           "acq_doppler_bin": acq.doppler_bin, "prn": prn, "acquired_freq": freq,
           "code_phase": phase,
           "status": [("L" if next(lost) else "T") if a else "-" for a in act]}
    for k in judge.TRACK_KEYS:
        full = np.zeros((len(prn), rx.ms_to_process))
        full[act] = trk[k]
        out[k] = full.astype(np.int64) if k == "absolute_sample" else full
    return out


def readings(cell: dict, config_table: dict, traffic: dict, seed: int, control: bool,
             device: str = "cuda", index: int = 0) -> dict:
    """The judge's numbers for capture ``index`` of ``seed``."""
    from softgnss_tpu_torch.pipeline import run_receiver

    dev = torch.device(device)
    table = config_table["receiver"]
    scene = generator.draw_scene(table, traffic, seed, index)
    capture = generator.synthesize(scene, dev)
    rx = reference.Receiver.from_table(table)
    t = time.perf_counter()
    if control:
        out = control_outputs(rx, capture)
        who = "control float32"
    else:
        res = run_receiver(receiver_config(table), signal=held(capture, traffic),
                           **job_options(traffic, dev))
        out = outputs_of(res)
        del res
        who = "program"
    made = time.perf_counter() - t
    t = time.perf_counter()
    numbers, _, why = judge.judge(rx, [(scene, capture, [out])])
    return {"workload": cell["name"], "seed": seed, "capture": index, "who": who,
            "numbers": numbers, "truth": why, "made_s": made, "judge_s": time.perf_counter() - t}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnss_bench.control: no CUDA device", file=sys.stderr)
        return 3
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    config_table = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    for seed, control in [(s, False) for s in args.seeds] + [(s, True) for s in args.control]:
        for i in range(int(traffic["captures"])):
            print(json.dumps(readings(cell, config_table, traffic, seed, control, index=i)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
