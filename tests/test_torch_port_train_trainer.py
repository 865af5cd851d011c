"""The port's ``PFrameTrainer`` and training CLI against ``dcvc_tpu`` on
the CPU.

* Two trainer steps: seeded *port* DMCHem (16 / 16 / 24) weights carried
  to JAX with ``port_hem.convert_dmc_hem``; both trainers run one stage
  (cascade 1, STE, MSE) for two one-step epochs on identically seeded
  ``SyntheticClips``. The per-step losses agree to 1e-4 relative;
  after the first AdamW update (each epoch's checkpoint, the JAX one read
  from its ``.npz``) every parameter is within 2 * lr of JAX's: the first
  update moves an element by about lr * sign(g), so an element whose
  gradient is ~0 may step either way.
* Remat with noise: the cascaded loss and every gradient with per-frame
  recomputation equal those without (rtol 1e-6), on the same weights, clip
  and noise seed: the frame's generator is made inside the recomputed
  function, so the recompute draws the same noise.
* The CLI (``python -m dcvc_tpu_torch.tools.train``) on the CPU at a small
  step count: checkpoint and ``history.json`` written, and restorable.
"""

import json

import numpy as np
import pytest
import torch

from dcvc_tpu.models.video_hem import DMCHem as JDMCHem
from dcvc_tpu.training import data as jdata
from dcvc_tpu.training import trainer as jtrainer
from dcvc_tpu.utils import port_hem
from dcvc_tpu_torch.models.video_hem import DMCHem
from dcvc_tpu_torch.tools import train as train_cli
from dcvc_tpu_torch.training import data as tdata
from dcvc_tpu_torch.training import trainer as ttrainer
from dcvc_tpu_torch.training.step import q_levels_for_batch
from dcvc_tpu_torch.utils.checkpoint import load_state_dict
from _flax_init import flax_param_checks  # noqa: F401 (autouse)

P_WIDTHS = {"channel_mv": 16, "channel_N": 16, "channel_M": 24}
LR = 1e-4
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six pytest workers on one host: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_hem(seed):
    torch.manual_seed(seed)
    return DMCHem(**P_WIDTHS)


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """Both trainers after two one-step epochs: (port trainer, JAX history,
    the port and JAX workdirs)."""
    tm = _port_hem(51)
    params = port_hem.convert_dmc_hem(
        {k: v.detach().numpy() for k, v in tm.state_dict().items()})
    kw = dict(epochs=2, cascade_frames=1, lr=LR)
    jdir = tmp_path_factory.mktemp("jax_train")
    tdir = tmp_path_factory.mktemp("port_train")
    jt = jtrainer.PFrameTrainer(JDMCHem(**P_WIDTHS), params,
                                schedule=[jtrainer.Stage("s", **kw)],
                                workdir=str(jdir),
                                apply_adapter=jtrainer.hem_adapter)
    jt.fit(jdata.SyntheticClips(crop=64, frames=3, seed=52), batch_size=2,
           steps_per_epoch=1)
    tt = ttrainer.PFrameTrainer(tm, schedule=[ttrainer.Stage("s", **kw)],
                                workdir=str(tdir),
                                apply_adapter=ttrainer.hem_adapter,
                                device="cpu")
    tt.fit(tdata.SyntheticClips(crop=64, frames=3, seed=52), batch_size=2,
           steps_per_epoch=1)
    return tt, jt.history, tdir, jdir


def test_two_trainer_steps_match_jax(two_steps):
    tt, jhist, _, _ = two_steps
    assert [r["epoch"] for r in tt.history] == [0, 1]
    tl = [r["loss"] for r in tt.history]
    jl = [r["loss"] for r in jhist]
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tt.updates == 2


def test_first_adamw_update_within_two_lr_of_jax(two_steps):
    _, _, tdir, jdir = two_steps
    port = load_state_dict(str(tdir / "s_ep0.pth"), "dmc_hem")
    ref = load_state_dict(str(jdir / "s_ep0.npz"), "dmc_hem")
    start = _port_hem(51).state_dict()
    assert set(port) == set(ref)
    moved = 0
    for k, v in ref.items():
        gap = (port[k] - v).abs().max().item()
        assert gap <= 2 * LR * (1 + 1e-3), (k, gap)
        moved += int(not torch.equal(port[k], start[k]))
    assert moved > len(ref) // 2


def test_restore_reads_pth_and_the_jax_npz(two_steps):
    tt, _, tdir, jdir = two_steps
    fresh = ttrainer.PFrameTrainer(_port_hem(53), workdir=str(tdir / "r"),
                                   apply_adapter=ttrainer.hem_adapter,
                                   device="cpu")
    fresh.restore(str(tdir / "s_ep1.pth"))
    for k, v in tt.module.state_dict().items():
        torch.testing.assert_close(fresh.module.state_dict()[k], v,
                                   rtol=0, atol=0)
    fresh.restore(str(jdir / "s_ep1.npz"))
    ref = load_state_dict(str(jdir / "s_ep1.npz"), "dmc_hem")
    for k, v in ref.items():
        torch.testing.assert_close(fresh.module.state_dict()[k], v,
                                   rtol=0, atol=0)
    hist = json.loads((tdir / "history.json").read_text())
    assert [r["loss"] for r in hist] == [r["loss"] for r in tt.history]


def test_validate_and_grad_norms(two_steps):
    tt, _, _, _ = two_steps
    data = tdata.SyntheticClips(crop=64, frames=3, seed=54)
    v = tt.validate(data, batch_size=2, steps=1)
    clip = next(tdata.SyntheticClips(crop=64, frames=3, seed=54)
                .batches(2, 1))
    _, lam = q_levels_for_batch(2, 0, tt.device)
    with torch.no_grad():
        ref = tt.loss(tt._clip(clip), lam, tt.schedule[0],
                      quant_mode="round")
    assert v == pytest.approx(float(ref), rel=1e-6)
    norms = tt.grad_norms(clip)
    assert set(norms) == {n.split(".")[0]
                          for n, _ in tt.module.named_parameters()}
    assert all(np.isfinite(g) for g in norms.values())
    assert norms["contextual_encoder"] > 0 and norms["y_q_scale"] == 0
    assert all(p.grad is None for p in tt.module.parameters())


def test_remat_with_noise_gives_the_same_gradients(tmp_path):
    """A cascade of 2 undetached frames under noise, with and without
    remat: the same loss and gradients."""
    clip = next(tdata.SyntheticClips(crop=64, frames=3, seed=55)
                .batches(2, 1))
    tr = ttrainer.PFrameTrainer(_port_hem(56), workdir=str(tmp_path),
                                apply_adapter=ttrainer.hem_adapter,
                                quant_mode="noise", device="cpu")
    x, (_, lam) = tr._clip(clip), q_levels_for_batch(2, 0, tr.device)
    out = {}
    for remat in (False, True):
        tr.module.zero_grad(set_to_none=True)
        stage = ttrainer.Stage("s", 1, cascade_frames=2, detach=False,
                               remat=remat)
        loss = tr.loss(x, lam, stage, key=57)
        loss.backward()
        out[remat] = (float(loss.detach()),
                      {n: p.grad.clone() for n, p in
                       tr.module.named_parameters() if p.grad is not None})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert set(out[True][1]) == set(out[False][1])
    for n, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][n], g, rtol=1e-6, atol=0)
    # another noise seed gives another loss: the noise is in the graph
    tr.module.zero_grad(set_to_none=True)
    other = float(tr.loss(x, lam, ttrainer.Stage("s", 1, cascade_frames=2,
                                                 detach=False),
                          key=58).detach())
    assert other != out[False][0]


def test_train_cli_on_the_cpu(tmp_path, monkeypatch):
    work = tmp_path / "w"
    tr = train_cli.main(["--model", "dmc_hem", "--steps_per_epoch", "1",
                         "--max_epochs", "1", "--batch_size", "1",
                         "--workdir", str(work), "--device", "cpu"])
    assert sorted(p.name for p in work.iterdir()) == [
        "history.json", "train_2frames_ep0.pth"]
    hist = json.loads((work / "history.json").read_text())
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert tr.updates == 1 and not tr.schedule[0].remat
    assert tr.module.mc_warp_mode is None      # the exact warp
    # --restore reads the checkpoint back; remat follows --remat
    tr2 = train_cli.main(["--model", "dmc_hem", "--steps_per_epoch", "1",
                          "--max_epochs", "1", "--batch_size", "1",
                          "--workdir", str(tmp_path / "w2"), "--device",
                          "cpu", "--remat", "1", "--restore",
                          str(work / "train_2frames_ep0.pth")])
    assert tr2.schedule[0].remat and tr2.updates == 1
    assert [st.epochs for st in train_cli.schedule_for(False, 6)] == [5, 1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device='cpu'"):
        train_cli.main(["--workdir", str(tmp_path / "w3")])
