"""Device ms per evaluation batch of the operations launched inside the
CHM head's other phases (fss/chm_corr: scale convs, correlations, 4D
resizes; fss/chm_pool: sigmoid, scale max-pool, 4D upsample;
fss/chm_readout: softplus, mutual filter, readout; models/chm.py), in the
traced window."""

from benchmark.harness import program_readers


def read(view):
    return program_readers.device_ms_within(view, ("fss/chm_corr", "fss/chm_pool",
                                                   "fss/chm_readout"))
