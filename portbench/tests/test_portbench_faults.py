"""The output check catches what it must: whole runs of the tiny cells on the
CPU (the harness's look for a card skipped), sound and with a fault planted
in the program underneath, and the controls (the plain reference computed
one precision below the configuration's, in the program's place)."""

import contextlib
import io
import json

import pytest
import torch

from portbench import control, run
from portbench.harness import check
from portbench.harness.cell import load

CPU = torch.device("cpu")


def line_of(root, workload, seed=11, seconds=0.3):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                         str(seconds)], device=CPU, root=root) == 0
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("workload", ["stream-int8-b1", "stream-int8-dist",
                                      "stream-bf16-flip", "train-bf16-b5t7"])
def test_a_sound_run_is_correct(tiny_root, cpu_threads, workload):
    line = line_of(tiny_root, workload, seed=2 ** 33 + 5)
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check" and line["attempted"] > 0 and line["failed"] == 0


def _state_unchanged(monkeypatch):
    from lstm_unet_tpu_torch.models import ULSTMnet2D

    step = ULSTMnet2D.step

    def frozen(self, state, frame, *args, out=None, **kw):
        new, logits = step(self, state, frame, *args, out=out, **kw)
        if out is None:
            return new, logits
        for lvl_in, lvl_out in zip(state, out):
            for pair_in, pair_out in zip(lvl_in, lvl_out):
                for a, b in zip(pair_in, pair_out):
                    b.copy_(a)
        return out, logits

    monkeypatch.setattr(ULSTMnet2D, "step", frozen)


def _labels_altered(monkeypatch):
    from lstm_unet_tpu_torch.engine import infer

    post = infer.postprocess_frame

    def altered(*args, **kw):  # one pixel made an instance of its own
        lbl = post(*args, **kw).clone()
        lbl[0, 0] = lbl.max() + 1
        return lbl

    monkeypatch.setattr(infer, "postprocess_frame", altered)


def _half_of_the_variants(monkeypatch):
    from lstm_unet_tpu_torch.engine.infer import StreamingInferenceEngine

    def half(self, logits, b, oh, ow):
        lv = logits.reshape((self.n_var, b) + logits.shape[1:])
        aligned = [lv[0], lv[1].flip(1)]
        return torch.softmax(torch.stack(aligned)[:, :, :oh, :ow], dim=-1).mean(dim=0)

    monkeypatch.setattr(StreamingInferenceEngine, "_probs", half)


def _params_unchanged(monkeypatch):
    from lstm_unet_tpu_torch.engine import optim

    def no_update(self, params, grads):
        return optim.global_norm([grads[n] for n in self.names])

    monkeypatch.setattr(optim.ClippedAdam, "step", no_update)


def _state_not_reset(monkeypatch):
    from lstm_unet_tpu_torch.models import ULSTMnet2D

    def kept(state, is_last):  # detached, as the reset leaves it, but not zeroed
        return [[(h.detach(), c.detach()) for h, c in lvl] for lvl in state]

    monkeypatch.setattr(ULSTMnet2D, "reset_lanes", staticmethod(kept))


def _half_of_the_batch(monkeypatch):
    from lstm_unet_tpu_torch.engine import train

    loss = train.weighted_ce_loss

    def half(logits, seg, valid, class_weights, full_seg=None):
        n = logits.shape[0] // 2
        return loss(logits[:n], seg[:n], valid[:n], class_weights,
                    None if full_seg is None else full_seg[:n])

    monkeypatch.setattr(train, "weighted_ce_loss", half)


@pytest.mark.parametrize("workload,fault", [
    ("stream-int8-b1", _state_unchanged),
    ("stream-int8-b1", _labels_altered),
    ("stream-int8-dist", _labels_altered),
    ("stream-bf16-flip", _state_unchanged),
    ("stream-bf16-flip", _half_of_the_variants),
    ("train-bf16-b5t7", _params_unchanged),
    ("train-bf16-b5t7", _half_of_the_batch),
    ("train-bf16-b5t7", _state_not_reset),
])
def test_a_fault_in_the_program_is_not_correct(tiny_root, cpu_threads, monkeypatch,
                                               workload, fault):
    fault(monkeypatch)
    line = line_of(tiny_root, workload)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("workload,variant", [
    ("stream-int8-b1", "int4"), ("stream-bf16-flip", "fp8"), ("train-bf16-b5t7", "fp8"),
])
def test_the_control_is_not_correct(tiny_root, cpu_threads, workload, variant):
    cell = load(workload, tiny_root)
    if cell.mode == "stream":
        numbers = control.stream_numbers(cell, 5, variant, CPU)
    else:
        numbers = control.train_numbers(cell, 5, variant, CPU)
    assert check.decide(numbers, cell.workload["limits"])["correct"] is False, numbers


@pytest.mark.cuda
def test_a_cell_is_correct_on_the_card(card):
    """One committed cell, short, on a card (skips here)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main(["--workload", "stream-int8-b1", "--seed", "7", "--seconds", "2"]) == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is True
