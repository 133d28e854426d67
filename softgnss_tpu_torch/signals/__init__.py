from softgnss_tpu_torch.signals.ca import (  # noqa: F401
    G2_DELAYS,
    ca_table,
    gold_code,
    gold_codes,
    padded_code,
    resample_indices,
)
from softgnss_tpu_torch.signals.nco import (  # noqa: F401
    CARRIER_FRAC_BITS,
    CODE_FRAC_BITS,
    CODE_ONE,
    carrier_step_u32,
    ceil_chip_index,
    chips_to_q,
    code_step_q,
)
