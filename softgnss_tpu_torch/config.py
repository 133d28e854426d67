"""Receiver configuration.

A frozen dataclass holding every knob of the reference settings object
(reference: initialize.py:80-185) and the derived quantities the stages
need.  Field names, defaults and derived properties are those of
``softgnss_tpu.config.ReceiverConfig``; the TPU layout knobs of that
package (capture word packing, Pallas contraction and tiling, scan unroll
and correlator tile) have no meaning on the GPU and are left out
(``convert.config_from_dict`` drops them).  Use
:meth:`ReceiverConfig.with_options` to derive variants.

Two trackers (:attr:`ReceiverConfig.tracker`): the block tracker (kernels
B2 + B1, or B3 with ``mega_fused_frames``) reads the capture through its
int32 word view and needs ``samples_per_code % 4 == 0``; the per-ms
tracker (kernel B4, loop filters in torch) takes any front end.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

#: ``correlator_impl`` values and the tracker each selects (None: by the
#: front end, :attr:`ReceiverConfig.tracker`).  Both trackers compute the
#: 'gather' formulation, so 'gather' resolves like 'auto'.
_TRACKERS = {"auto": None, "gather": None, "megakernel": "block",
             "onehot": "per_ms", "pallas": "per_ms"}


@dataclass(frozen=True)
class ReceiverConfig:
    """All receiver knobs (see softgnss_tpu.config for each field's notes)."""

    # --- processing -------------------------------------------------------
    #: milliseconds of capture to process (reference: initialize.py:85)
    ms_to_process: int = 37000
    #: number of tracking channels (reference: initialize.py:88)
    number_of_channels: int = 8
    #: samples to skip at the start of the capture (initialize.py:94)
    skip_samples: int = 0

    # --- raw signal front-end ---------------------------------------------
    file_name: str = ""
    #: on-disk sample encoding, see softgnss_tpu_torch.io
    data_format: str = "int8"
    intermediate_freq: float = 9_548_000.0
    sampling_freq: float = 38_192_000.0
    code_freq_basis: float = 1_023_000.0
    code_length: int = 1023

    # --- acquisition --------------------------------------------------------
    skip_acquisition: bool = False
    acq_satellite_list: tuple[int, ...] = tuple(range(1, 33))
    acq_search_band_khz: float = 14.0
    acq_threshold: float = 2.5
    acq_doppler_step_hz: float = 500.0
    acq_fine_freq_ms: int = 10
    acq_fine_decimation: int = 512
    acq_fine_fft: int = 8192
    acq_fine_band_hz: float = 400.0
    #: 2 = the reference's best-of-two-ms scheme; K > 2 sums K ms
    acq_noncoherent_ms: int = 2

    # --- tracking loops ----------------------------------------------------
    dll_damping_ratio: float = 0.7
    dll_noise_bandwidth: float = 2.0
    dll_correlator_spacing: float = 0.5
    pll_damping_ratio: float = 0.7
    pll_noise_bandwidth: float = 25.0
    dll_loop_gain: float = 1.0
    pll_loop_gain: float = 0.25
    #: FLL assist noise bandwidth, Hz (0 = off, the reference behaviour)
    fll_bandwidth_hz: float = 0.0
    #: code NCO follows the carrier Doppler scaled by f_code/f_L1
    carrier_aided_dll: bool = False
    #: coherent integration in code periods (1 = the reference)
    pdi_ms: int = 1

    # --- navigation solution -------------------------------------------------
    nav_sol_period_ms: int = 500
    elevation_mask_deg: float = 10.0
    use_trop_corr: bool = True
    use_iono_corr: bool = True
    carrier_smoothing_epochs: int = 0
    true_position: tuple[float, float, float] | None = None
    raim: bool = True
    raim_sigma_m: float | None = None
    raim_sigma_floor_m: float = 3.0
    nav_filter: str = "lsq"
    ekf_accel_psd: float = 2.0
    ekf_clock_psd: float = 1.0
    ekf_clock_bias_psd: float = 0.1
    ekf_range_sigma_m: float | None = None
    ekf_doppler_sigma: float = 0.15
    ekf_gate_sigma: float = 6.0

    # --- lock monitoring -----------------------------------------------------
    lock_demotion: bool = True
    lock_window_ms: int = 1000
    lock_cn0_threshold_dbhz: float = 28.0
    lock_pll_threshold: float = 0.5

    # --- plotting ------------------------------------------------------------
    plot_tracking: bool = False

    # --- constants -----------------------------------------------------------
    speed_of_light: float = 299_792_458.0
    start_offset_ms: float = 68.802
    l1_freq: float = 1_575_420_000.0

    # --- execution -------------------------------------------------------------
    #: PRNs per acquisition chunk (bounds the (chunk, doppler, lag) grid)
    acq_prn_chunk: int = 8
    #: extra samples beyond samples_per_code in each tracking frame
    track_window_extra: int = 8
    #: milliseconds per tracking block (one build_frames + track_block pair)
    track_block_ms: int = 64
    #: total static slack (samples) around each frame; 0 = auto-size
    track_frame_margin: int = 0
    #: 'megakernel' selects the block tracker, 'onehot' / 'pallas' the
    #: per-ms tracker; 'auto' and 'gather' pick the block tracker when
    #: samples_per_code % 4 == 0 and the per-ms tracker otherwise
    correlator_impl: str = "auto"
    #: block tracker only: read each ms window straight from the capture
    #: inside the tracking kernel (B3) instead of building frames first (B2)
    mega_fused_frames: bool = False
    #: mesh dimension names of sharded runs (softgnss_tpu_torch.parallel)
    time_axis: str = "time"
    channel_axis: str = "channel"
    #: re-lock ms each time shard tracks before its outputs count
    #: (parallel.track_time_sharded; clipped to [1, block - 2])
    time_shard_warmup_ms: int = 250
    #: time-chunk size (ms) of the streamed tracker (parallel.stream)
    track_stream_chunk_ms: int = 4096

    def __post_init__(self):
        if self.correlator_impl not in _TRACKERS:
            raise ValueError(
                f"correlator_impl={self.correlator_impl!r}: expected one of "
                f"{', '.join(map(repr, _TRACKERS))}")

    # --- derived ----------------------------------------------------------------
    @property
    def tracker(self) -> str:
        """'block' (B2 + B1, or B3) or 'per_ms' (B4): the tracker
        ``correlator_impl`` selects.  'auto' mirrors the JAX package's TPU
        resolution: the block kernels where the int32 word view frames the
        code period, the per-ms kernel elsewhere."""
        chosen = _TRACKERS[self.correlator_impl]
        if chosen is None:
            chosen = "block" if self.samples_per_code % 4 == 0 else "per_ms"
        if chosen == "block" and self.samples_per_code % 4:
            raise ValueError(
                f"correlator_impl={self.correlator_impl!r} selects the block "
                "tracker, which reads the capture as int32 words and needs "
                f"samples_per_code % 4 == 0 (got {self.samples_per_code}); use "
                "'auto' or 'pallas' (the per-ms tracker) for this front end")
        return chosen

    @property
    def samples_per_code(self) -> int:
        return int(round(self.sampling_freq / (self.code_freq_basis / self.code_length)))

    @property
    def samples_per_chip(self) -> int:
        return int(round(self.sampling_freq / self.code_freq_basis))

    @property
    def num_doppler_bins(self) -> int:
        band_hz = self.acq_search_band_khz * 1000.0
        return int(round(band_hz / self.acq_doppler_step_hz)) + 1

    @property
    def doppler_bin_freqs(self) -> tuple[float, ...]:
        lo = self.intermediate_freq - self.acq_search_band_khz / 2.0 * 1000.0
        return tuple(lo + self.acq_doppler_step_hz * i for i in range(self.num_doppler_bins))

    @property
    def pdi_s(self) -> float:
        return self.pdi_ms * 1e-3

    @property
    def track_frame_pre(self) -> int:
        """Nominal offset of a true ms boundary inside its frame: ~1 chip of
        DLL pull-in plus the code-Doppler drift over a block, plus slack
        (softgnss_tpu.config.ReceiverConfig.track_frame_pre)."""
        if self.track_block_ms <= 1:
            return 0
        if self.track_frame_margin > 0:
            return self.track_frame_margin // 2
        drift = 6e-6 * self.track_block_ms * self.samples_per_code
        return self.samples_per_chip + int(math.ceil(drift)) + 8

    @property
    def track_window(self) -> int:
        """Samples per tracking frame: one code period plus the extra and
        the frame slack, rounded up to whole 4-sample capture words."""
        w = self.samples_per_code + self.track_window_extra + 2 * self.track_frame_pre
        return (w + 3) // 4 * 4

    @property
    def acquisition_ms(self) -> int:
        return max(self.acq_fine_freq_ms, self.acq_noncoherent_ms) + 1

    def loop_coefficients(self, noise_bw: float, damping: float, gain: float) -> tuple[float, float]:
        """Second-order loop filter (tau1, tau2) (reference: initialize.py:306-328)."""
        wn = noise_bw * 8.0 * damping / (4.0 * damping**2 + 1.0)
        return gain / (wn * wn), 2.0 * damping / wn

    @property
    def dll_taus(self) -> tuple[float, float]:
        return self.loop_coefficients(self.dll_noise_bandwidth, self.dll_damping_ratio, self.dll_loop_gain)

    @property
    def pll_taus(self) -> tuple[float, float]:
        return self.loop_coefficients(self.pll_noise_bandwidth, self.pll_damping_ratio, self.pll_loop_gain)

    def total_samples_needed(self) -> int:
        return self.skip_samples + (self.ms_to_process + 2) * self.samples_per_code

    def with_options(self, **kwargs) -> "ReceiverConfig":
        return dataclasses.replace(self, **kwargs)


def default_config(**kwargs) -> ReceiverConfig:
    """The reference's default workload: fs=38.192 MHz, IF=9.548 MHz, 8 ch."""
    return ReceiverConfig(**kwargs)


def fast_config(**kwargs) -> ReceiverConfig:
    """A small, fast configuration for tests: fs=4.096 MHz, IF=1 MHz."""
    base = dict(
        sampling_freq=4_096_000.0,
        intermediate_freq=1_000_000.0,
        ms_to_process=1000,
        number_of_channels=4,
    )
    base.update(kwargs)
    return ReceiverConfig(**base)
