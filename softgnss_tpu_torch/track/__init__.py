from softgnss_tpu_torch.track.scan import TrackResults, TrackState, initial_state, track  # noqa: F401
