"""The trainer's streaming path and the scaled EMD past kernel E on the card,
with no JAX import, so that these tests run wherever the port does (`cuda`
marker; `python -m pytest tests/test_torch_trainer_parts_card.py -m cuda
-q` on the H100; they skip without a GPU). Their CPU counterparts, held
against the JAX package, are `tests/test_torch_trainer_parts.py` and
`tests/test_torch_emd_large.py`.

- `prefetch_to_device` lands the host batches unchanged and in order on
  the card, also when the consumer's stream is busy while the copies run;
- a Trainer above the (lowered) device-data line trains on the card on the
  batches of `epoch_batches`;
- `auction_scaled_jacobi` gives the same assignments, prices and rounds on
  the card as on the CPU, on the same d at [2, 512, 512].
"""

import numpy as np
import pytest
import torch

from sp_gan_tpu_torch.config import Config
from sp_gan_tpu_torch.data import h5
from sp_gan_tpu_torch.data.prefetch import prefetch_to_device
from sp_gan_tpu_torch.ops import emd
from sp_gan_tpu_torch.ops.pairwise import pairwise_sqdist
from sp_gan_tpu_torch.train import trainer as trainer_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_prefetch_lands_host_batches(card):
    rng = np.random.default_rng(0)
    host = [rng.standard_normal((24, 2048, 3)).astype(np.float32)
            for _ in range(6)]
    got = []
    for b in prefetch_to_device(iter(host), size=2, device=card):
        # keep the consumer's stream busy while the next copies run
        torch.cuda._sleep(2_000_000)
        got.append(b.clone())
    assert len(got) == len(host)
    for a, h in zip(got, host):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), torch.from_numpy(h))


def test_streaming_trainer_on_card(card, tmp_path, monkeypatch):
    ds = h5.SyntheticDataset(n_items=12, n_points=64)
    monkeypatch.setattr(trainer_mod, "DEVICE_DATA_BYTES", ds.data.nbytes - 1)
    cfg = Config(np=64, bs=4, nk=8, nz=16, steps_per_epoch=3, seed=2,
                 log_dir=str(tmp_path))
    tr = trainer_mod.Trainer(cfg, dataset=ds, device="cuda", logs=False)
    assert tr.data is None
    seen = []
    step = tr.train_step

    def spy(state, real):
        seen.append(real.cpu())
        return step(state, real)
    tr.train_step = spy
    run = tr.time_steps(3)
    want = list(ds.epoch_batches(np.random.default_rng(2), 4))
    for a, b in zip(seen, want):
        assert a.numpy().tobytes() == b.tobytes()
    assert np.isfinite([[m["d_loss"], m["g_loss"]]
                        for m in run["metrics"]]).all()


def test_scaled_jacobi_card_equals_cpu(card):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 512, 3)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 512, 3)).astype(np.float32))
    d = pairwise_sqdist(x, y)
    for b in range(2):
        cpu = emd.auction_scaled_jacobi(d[b], 0.002, 10000, 4,
                                        return_state=True)
        gpu = emd.auction_scaled_jacobi(d[b].to(card), 0.002, 10000, 4,
                                        return_state=True)
        assert torch.equal(gpu[0].cpu(), cpu[0])
        assert torch.equal(gpu[1].cpu(), cpu[1])
        assert gpu[2] == cpu[2] < 10000
