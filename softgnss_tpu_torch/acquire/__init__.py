from softgnss_tpu_torch.acquire.search import (  # noqa: F401
    AcquisitionResults,
    Channels,
    acquire,
    assign_channels,
    format_channel_status,
)
