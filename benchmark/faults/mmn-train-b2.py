"""The faults of mmn-train-b2: a step that leaves the state unchanged, half
the batch left out, and steps skipped once the window runs."""

from benchmark.harness.faults import (train_half_batch, train_state_unchanged,
                                      train_update_skipped_once_warm)

FAULTS = [train_state_unchanged, train_half_batch, train_update_skipped_once_warm]
