"""Tests of the port that need an NVIDIA card; each skips without one.

They import neither JAX nor the JAX package, so they also run where only
PyTorch is installed. On the card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card.py
"""

import pytest
import torch

from motionmixerconv_tpu_torch.train import make_optimizer


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _trajectory(opt, p, n):
    """``n`` steps of ``opt`` on gradients that depend on ``p``; the
    parameter after each."""
    out = []
    for i in range(n):
        p.grad = torch.sin(p.detach() * 3 + i)
        opt.step()
        out.append(p.detach().clone())
    return out


@pytest.mark.card
def test_optimizer_state_crosses_cpu_and_card(card, tmp_path):
    """On the card the optimizer is capturable with a device lr; a state it
    saved loads on the CPU and the CPU's on the card (through the file, as
    ``restore_checkpoint`` reads it), and both continue the trajectory
    across a milestone (float32 Adam in two formulas: rtol 1e-5)."""
    kw = dict(lr=1e-2, milestones=[1], gamma=0.5, steps_per_epoch=4)
    for src, dst in ((torch.device("cpu"), card), (card, torch.device("cpu"))):
        p = torch.nn.Parameter(torch.linspace(-1, 1, 7, device=src))
        opt = make_optimizer([p], **kw)
        assert opt.capturable == (src.type == "cuda")
        _trajectory(opt, p, 3)
        torch.save(opt.state_dict(), tmp_path / "opt.pt")
        start = p.detach().cpu().clone()
        want = [t.cpu() for t in _trajectory(opt, p, 4)]
        q = torch.nn.Parameter(start.to(dst))
        fresh = make_optimizer([q], **kw)
        fresh.load_state_dict(torch.load(tmp_path / "opt.pt",
                                         map_location="cpu", weights_only=True))
        assert (fresh.steps, fresh.lr) == (3, 1e-2)
        assert fresh.adam.param_groups[0]["capturable"] == (dst.type == "cuda")
        got = [t.cpu() for t in _trajectory(fresh, q, 4)]
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
