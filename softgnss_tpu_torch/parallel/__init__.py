"""Beyond one tracking call: software-pipelined tracking over time chunks
(:func:`track_streamed`, softgnss_tpu.parallel.stream), on one device.

The multi-device layer of softgnss_tpu.parallel (device meshes, PRN-
sharded acquisition, channel- and time-sharded tracking) is not ported
yet (ROADMAP A.9).
"""

from softgnss_tpu_torch.parallel.stream import track_streamed  # noqa: F401
