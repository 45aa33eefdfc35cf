"""The faults of the staged four-card mmn-ddp4-train: a step that leaves the
state unchanged, half the batch left out, and the exchange between the
cards left out."""

from benchmark.harness.faults import ddp_exchange_left_out, train_half_batch, train_state_unchanged

FAULTS = [train_state_unchanged, train_half_batch, ddp_exchange_left_out]
