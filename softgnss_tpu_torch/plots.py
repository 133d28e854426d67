"""Plot dashboards: probe, acquisition, tracking, lock quality, navigation.

The port of softgnss_tpu.plots: the reference's three .plot() dashboards
and its probeData plots (acquisition.py:206-256, tracking.py:297-426,
postNavigation.py:307-439, initialize.py:377-414), rendered headless to
PNG files from the NumPy results, after the run and never inside it.
matplotlib is imported only when a plot is drawn; without it every
``plot_*`` raises a RuntimeError that says so (no plot is skipped
silently).
"""

from __future__ import annotations

import os

import numpy as np

from softgnss_tpu_torch.config import ReceiverConfig


def _mpl():
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("plotting needs matplotlib, which is not installed; run "
                           "without --plot (or install matplotlib)") from exc
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_probe(config: ReceiverConfig, stats: dict, out_dir: str = ".") -> str:
    """Time-domain / PSD / histogram QC figure (reference: initialize.py:377-414)."""
    plt = _mpl()
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    ax = axes[0, 0]
    ax.plot(stats["time_axis_ms"], stats["time_series"], lw=0.5)
    ax.set(title="Time domain", xlabel="Time (ms)", ylabel="Amplitude")
    ax = axes[0, 1]
    ax.semilogy(stats["psd_freqs_hz"] / 1e6, np.maximum(stats["psd"], 1e-20))
    ax.set(title="Power spectral density", xlabel="Frequency (MHz)", ylabel="PSD")
    ax = axes[1, 0]
    ax.bar(stats["hist_values"], stats["hist_counts"],
           width=max(1.0, (np.ptp(stats["hist_values"]) or 1) / 50))
    ax.set(title="Histogram", xlabel="Sample value", ylabel="Count")
    axes[1, 1].axis("off")
    axes[1, 1].text(0.05, 0.6, f"samples: {stats['n_samples']}\n"
                               f"mean: {stats['mean']:.3f}\nstd: {stats['std']:.2f}\n"
                               f"clipped: {100 * stats['clipped_fraction']:.2f}%")
    fig.suptitle("Raw IF data probe")
    fig.tight_layout()
    path = os.path.join(out_dir, "probe.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_acquisition(config: ReceiverConfig, acq, out_dir: str = ".") -> str:
    """Peak-metric bar chart, acquired PRNs highlighted
    (reference: acquisition.py:206-256)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 4))
    prns = np.arange(1, len(acq.peak_metric) + 1)
    colors = np.where(acq.acquired, "tab:green", "tab:blue")
    ax.bar(prns, acq.peak_metric, color=colors)
    ax.axhline(config.acq_threshold, color="r", ls="--", lw=1,
               label=f"threshold {config.acq_threshold}")
    ax.set(title="Acquisition results", xlabel="PRN number",
           ylabel="Acquisition metric", xticks=prns[1::2])
    ax.legend(["threshold", "not acquired", "acquired"])
    fig.tight_layout()
    path = os.path.join(out_dir, "acquisition.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_tracking(config: ReceiverConfig, tracking, channel: int,
                  out_dir: str = ".") -> str:
    """3x3 per-channel tracking dashboard (reference: tracking.py:297-426)."""
    plt = _mpl()
    c = channel
    ms = np.arange(tracking.n_ms)
    fig, axes = plt.subplots(3, 3, figsize=(13, 9))
    fig.suptitle(f"Channel {c} (PRN {tracking.prn[c]}) results")

    ax = axes[0, 0]
    ax.plot(tracking.i_p[c], tracking.q_p[c], ".", ms=1)
    ax.set(title="Discrete-time scatter plot", xlabel="I prompt", ylabel="Q prompt")
    ax.axis("equal")

    axes[0, 1].plot(ms, tracking.i_p[c], lw=0.5)
    axes[0, 1].set(title="Bits of the navigation message", xlabel="Time (ms)")

    axes[0, 2].plot(ms, tracking.carr_freq[c] - config.intermediate_freq, lw=0.7)
    axes[0, 2].set(title="Carrier Doppler", xlabel="Time (ms)", ylabel="Hz")

    axes[1, 0].plot(ms, tracking.pll_discr[c], lw=0.5)
    axes[1, 0].set(title="Raw PLL discriminator", xlabel="Time (ms)", ylabel="Amplitude")

    axes[1, 1].plot(ms, np.hypot(tracking.i_e[c], tracking.q_e[c]), lw=0.5)
    axes[1, 1].plot(ms, np.hypot(tracking.i_p[c], tracking.q_p[c]), lw=0.5)
    axes[1, 1].plot(ms, np.hypot(tracking.i_l[c], tracking.q_l[c]), lw=0.5)
    axes[1, 1].legend(["Early", "Prompt", "Late"], fontsize=8)
    axes[1, 1].set(title="Correlation results", xlabel="Time (ms)")

    axes[1, 2].plot(ms, tracking.pll_discr_filt[c], lw=0.5)
    axes[1, 2].set(title="Filtered PLL discriminator", xlabel="Time (ms)")

    axes[2, 0].plot(ms, tracking.dll_discr[c], lw=0.5)
    axes[2, 0].set(title="Raw DLL discriminator", xlabel="Time (ms)", ylabel="Amplitude")

    axes[2, 1].plot(ms, tracking.code_freq[c] - config.code_freq_basis, lw=0.7)
    axes[2, 1].set(title="Code frequency offset", xlabel="Time (ms)", ylabel="Hz")

    axes[2, 2].plot(ms, tracking.dll_discr_filt[c], lw=0.5)
    axes[2, 2].set(title="Filtered DLL discriminator", xlabel="Time (ms)")

    fig.tight_layout()
    path = os.path.join(out_dir, f"tracking_ch{c}.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_lock(config: ReceiverConfig, tracking, out_dir: str = ".") -> str:
    """All-channel lock-quality dashboard (beyond the reference, which
    plots only per-channel loop observables): windowed Van Dierendonck
    C/N0, NBD/NBP phase-lock indicator, and code-rate offset per channel,
    with the demotion thresholds and any lock-loss marks overlaid
    (profiling.lock_metrics / channel_lock_loss)."""
    from softgnss_tpu_torch.profiling import lock_metrics

    plt = _mpl()
    window = min(int(config.lock_window_ms), max(100, tracking.n_ms // 4))
    hop = max(window // 2, 20)
    m = lock_metrics(config, tracking, window_ms=window, hop_ms=hop)
    t = (np.arange(m["cn0_dbhz"].shape[1]) * hop + window / 2) / 1000.0
    live = [c for c in range(len(tracking.prn)) if tracking.status[c] != "-"]

    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    fig.suptitle("Lock quality (windowed)")
    cn0_floor = (config.lock_cn0_threshold_dbhz
                 - 10.0 * np.log10(config.pdi_ms))
    for c in live:
        label = f"ch {c} (PRN {tracking.prn[c]})"
        axes[0].plot(t, m["cn0_dbhz"][c], lw=1, label=label)
        axes[1].plot(t, m["pll_lock"][c], lw=1, label=label)
        axes[2].plot(t, m["code_rate_offset_hz"][c], lw=1, label=label)
        if tracking.lock_loss_ms is not None and np.isfinite(tracking.lock_loss_ms[c]):
            for ax in axes:
                ax.axvline(tracking.lock_loss_ms[c] / 1000.0, color="r",
                           ls=":", lw=1)
    axes[0].axhline(cn0_floor, color="k", ls="--", lw=0.8)
    axes[0].set(title="C/N0 (Van Dierendonck)", ylabel="dB-Hz")
    axes[1].axhline(config.lock_pll_threshold, color="k", ls="--", lw=0.8)
    axes[1].set(title="Phase lock (NBD/NBP)", ylabel="indicator")
    axes[2].set(title="Code-rate offset from nominal", xlabel="Time (s)",
                ylabel="Hz")
    axes[0].legend(fontsize=8, ncol=2)
    fig.tight_layout()
    path = os.path.join(out_dir, "lock_quality.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_navigation(config: ReceiverConfig, solutions, out_dir: str = ".") -> str:
    """ENU variations + 3D scatter + polar sky plot with mean PDOP
    (reference: postNavigation.py:307-439)."""
    plt = _mpl()
    sol = solutions
    if config.true_position is not None:
        ref_e, ref_n, ref_u = config.true_position
        ref_label = "Reference position"
    else:
        ref_e, ref_n, ref_u = (np.nanmean(sol.e), np.nanmean(sol.n), np.nanmean(sol.u))
        ref_label = (f"Mean position\nlat {np.nanmean(sol.latitude):.5f}\n"
                     f"lon {np.nanmean(sol.longitude):.5f}\n"
                     f"hgt {np.nanmean(sol.height):+.1f}")

    fig = plt.figure(figsize=(12, 9))
    ax1 = fig.add_subplot(2, 1, 1)
    ax1.plot(sol.e - ref_e, label="E")
    ax1.plot(sol.n - ref_n, label="N")
    ax1.plot(sol.u - ref_u, label="U")
    if getattr(sol, "vx", None) is not None and np.isfinite(sol.vx).any():
        ax1.plot(np.sqrt(sol.vx**2 + sol.vy**2 + sol.vz**2), "--",
                 label="|v| (m/s)", alpha=0.7)
    title = "Coordinate variations in UTM system"
    if getattr(sol, "lsq_x", None) is not None:
        # EKF-filtered run: overlay the raw per-epoch LS scatter as the
        # horizontal miss distance so the filter's smoothing is visible
        d_ls = np.sqrt((sol.lsq_x - sol.x) ** 2 + (sol.lsq_y - sol.y) ** 2
                       + (sol.lsq_z - sol.z) ** 2)
        ax1.plot(d_ls, ":", label="|LS - EKF| (m)", alpha=0.7)
        title += " (EKF; dotted: per-epoch LS offset)"
    ax1.legend()
    ax1.set(title=title,
            xlabel=f"Measurement period: {config.nav_sol_period_ms} ms",
            ylabel="Variations (m)")

    ax2 = fig.add_subplot(2, 2, 3, projection="3d")
    ax2.plot(sol.e - ref_e, sol.n - ref_n, sol.u - ref_u, "+")
    ax2.plot([0], [0], [0], "r+", ms=12)
    ax2.set(title="Positions in UTM (3D)", xlabel="East (m)", ylabel="North (m)",
            zlabel="Up (m)")

    ax3 = fig.add_subplot(2, 2, 4, projection="polar")
    az = np.deg2rad(np.nan_to_num(sol.az, nan=0.0))
    r = 90 - np.nan_to_num(sol.el, nan=90.0)
    for c in range(sol.az.shape[0]):
        if np.isfinite(sol.el[c]).any():
            ax3.plot(az[c], r[c], ".", ms=2)
            k = np.isfinite(sol.el[c]).nonzero()[0][0]
            ax3.text(az[c, k], r[c, k], str(int(sol.prn[c, k])))
    ax3.set_theta_direction(-1)
    ax3.set_theta_zero_location("N")
    ax3.set_ylim(0, 90)
    ax3.set_yticks([0, 15, 30, 45, 60, 75])
    ax3.set_yticklabels(["90", "75", "60", "45", "30", "15"])
    ax3.set_title(f"Sky plot (mean PDOP {np.nanmean(sol.dop[1]):.2f})\n{ref_label}",
                  fontsize=8)

    fig.tight_layout()
    path = os.path.join(out_dir, "navigation.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_all(config: ReceiverConfig, results, out_dir: str = ".") -> list[str]:
    """Render every applicable dashboard for a ReceiverResults."""
    paths = []
    if results.probe is not None:
        paths.append(plot_probe(config, results.probe, out_dir))
    if results.acquisition is not None:
        paths.append(plot_acquisition(config, results.acquisition, out_dir))
    if results.tracking is not None and config.plot_tracking:
        for c in range(len(results.tracking.prn)):
            if results.tracking.status[c] != "-":
                paths.append(plot_tracking(config, results.tracking, c, out_dir))
    if (results.tracking is not None
            and any(s != "-" for s in results.tracking.status)
            and results.tracking.n_ms >= 120):   # plot_lock's window + 20
        paths.append(plot_lock(config, results.tracking, out_dir))
    if results.solutions is not None:
        paths.append(plot_navigation(config, results.solutions, out_dir))
    return paths
