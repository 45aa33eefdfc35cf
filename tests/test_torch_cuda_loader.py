"""The episode loader's pinned ring on the card: batches arrive on the
device equal to their host collation, through ``prefetch + 1`` pinned slots
allocated once, on a stream that the consumer's stream waits on.

Marked ``cuda``: each test skips when no CUDA device is present (decided in
the fixture, not at import). Run on a machine with a card:

    python -m pytest tests/test_torch_cuda_loader.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch.data.loader import EpisodeLoader, collate

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pinned ring copies to the card)")
    return torch.device("cuda")


class _Records:
    """Records of 1 MB images and int32 labels that name their index."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"q_img": rng.standard_normal((128, 128, 16)).astype(np.float32),
                "q_label": np.full((128, 128), i, np.int32), "cls": np.int32(i)}


@pytest.mark.parametrize("workers,prefetch", [(0, 1), (3, 1), (3, 3)])
def test_batches_arrive_equal_through_pinned_slots(device, workers, prefetch):
    ds = _Records()
    loader = EpisodeLoader(ds, batch_size=4, shuffle=True, num_workers=workers, seed=5,
                           prefetch=prefetch, device=device)
    for epoch in range(3):
        loader.set_epoch(epoch)
        order = np.random.default_rng(5 + epoch).permutation(len(ds))
        for b, batch in enumerate(loader):
            want = collate([ds[int(i)] for i in order[4 * b:4 * b + 4]])
            for k, v in want.items():
                assert batch[k].device.type == "cuda"
                assert batch[k].dtype == torch.from_numpy(v).dtype, k
                # read on the consumer's stream with no host synchronise first
                assert torch.equal(batch[k].cpu(), torch.from_numpy(v)), (epoch, b, k)
    ring = loader._ring
    assert ring.slots == prefetch + 1 and len(ring.buffers) == prefetch + 1
    assert all(buf.is_pinned() for slot in ring.buffers for buf in slot.values())
    ptrs = [buf.data_ptr() for slot in ring.buffers for buf in slot.values()]
    list(loader)  # another epoch reuses the same pinned slots
    assert ptrs == [buf.data_ptr() for slot in loader._ring.buffers for buf in slot.values()]


def test_a_consumer_on_its_own_stream_waits_for_the_copy(device):
    ds = _Records()
    loader = EpisodeLoader(ds, batch_size=8, shuffle=False, num_workers=2, prefetch=2,
                           device=device)
    consumer = torch.cuda.Stream(device)
    sums = []
    with torch.cuda.stream(consumer):
        for batch in loader:
            # a long kernel queued first keeps the consumer busy while later
            # copies land in recycled slots
            torch.cuda._sleep(2_000_000)
            sums.append(batch["q_img"].double().sum(dim=(1, 2, 3)))
    torch.cuda.synchronize()
    want = [float(ds[i]["q_img"].astype(np.float64).sum()) for i in range(len(ds))]
    np.testing.assert_allclose(torch.cat(sums).cpu().numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("workers", [0, 3])
def test_a_short_tail_batch_fills_the_first_rows_of_a_slot(device, workers):
    """``drop_last=False`` (stage-1 standard validation): the tail batch of
    24 records in batches of 5 has 4 rows, copied from the first rows of a
    slot allocated at the full batch; the next pass reuses the slots."""
    ds = _Records()
    loader = EpisodeLoader(ds, batch_size=5, shuffle=False, num_workers=workers, prefetch=1,
                           drop_last=False, device=device)
    for _ in range(2):
        batches = list(loader)
        assert [b["q_img"].shape[0] for b in batches] == [5, 5, 5, 5, 4]
        for b, batch in enumerate(batches):
            want = collate([ds[i] for i in range(5 * b, min(5 * b + 5, len(ds)))])
            for k, v in want.items():
                assert torch.equal(batch[k].cpu(), torch.from_numpy(v)), (b, k)
    assert all(buf.shape[0] == 5 for slot in loader._ring.buffers for buf in slot.values())
