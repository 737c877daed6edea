"""The check catches a broken program, and its control fails: tiny cells
on the CPU, the look for a card skipped, the rest of a run driven as the
card's run drives it, with the port broken underneath.

Faults, for each cell that can have them (one card: no exchange between
cards to leave out):
- a step that returns its state unchanged (training: the optimizer
  writes nothing; decode: the cache is not written);
- half of the batch left out (training: the loss is the mean over the
  other half; serving: the second half's answers never computed);
- an answer altered where it is produced (training: the step's loss off
  by 1%; serving: the served token moved to the next id, at each
  prompt's last position or at every decode step).

The control: the plain reference in fp8 in the program's place."""

import pytest

from portbench import harness
from portbench.tests import tiny

TRAIN = ["qwen2-1.5b.train", "mamba2-1.3b.train"]
SERVE = ["qwen2-1.5b.prefill", "qwen2-1.5b.decode"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
@pytest.mark.parametrize("seed", [1, 2])
def test_sound_runs_are_correct(workload, seed):
    out = tiny.run(workload, seed=seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _unchanged_optimizer(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers.Optimizer, "update_tree",
                        lambda self, params, slots, grads, step:
                        (params, slots))


def _half_batch_loss(monkeypatch):
    from repro_torch.training import trainer
    real = trainer.loss_fn

    def half(params, cfg, batch, aux_weight=0.01):
        tokens = batch["tokens"]
        return real(params, cfg, {"tokens": tokens[:tokens.shape[0] // 2]},
                    aux_weight)
    monkeypatch.setattr(trainer, "loss_fn", half)


def _altered_loss(monkeypatch):
    import repro_torch.training as training
    real = training.make_train_step

    def make(cfg, optimizer=None, aux_weight=0.01):
        step = real(cfg, optimizer, aux_weight)

        def altered(state, batch):
            state, metrics = step(state, batch)
            return state, {**metrics, "loss": metrics["loss"] * 1.01}
        return altered
    monkeypatch.setattr(training, "make_train_step", make)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged_optimizer, _half_batch_loss,
                                   _altered_loss],
                         ids=["unchanged", "half_batch", "altered"])
def test_train_faults_are_caught(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not tiny.run(workload)["correct"]


def _wrap_logits(monkeypatch, module, name, alter):
    """``module.name``, a function returning logits first, with ``alter``
    applied to what it returns."""
    real = getattr(module, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        if isinstance(out, tuple):
            return (alter(out[0]),) + tuple(out[1:])
        return alter(out)
    monkeypatch.setattr(module, name, wrapped)


def _second_half_missing(logits):
    logits = logits.clone()
    logits[logits.shape[0] // 2:] = 0
    return logits


def _moved_token(logits):
    """The top token of each prompt's last position (prefill) or of the
    step (decode) moved to the next id."""
    logits = logits.clone()
    last = logits[:, -1] if logits.dim() == 3 else logits
    top = last.argmax(-1, keepdim=True)
    last.scatter_(-1, (top + 1) % last.shape[-1],
                  last.max(-1, keepdim=True).values + 1)
    return logits


def _serving_fault(workload, kind, monkeypatch):
    from repro_torch.serving import predictor
    if kind == "unchanged":
        from repro_torch.models import model
        real = model.decode_step
        monkeypatch.setattr(
            predictor, "decode_step", lambda params, cfg, cache, tokens,
            pos: (real(params, cfg, _clone(cache), tokens, pos)[0], cache))
        return
    alter = _second_half_missing if kind == "half_batch" else _moved_token
    name = "forward" if workload.endswith("prefill") else "decode_step"
    _wrap_logits(monkeypatch, predictor, name, alter)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("workload,kind", [
    ("qwen2-1.5b.prefill", "half_batch"), ("qwen2-1.5b.prefill", "altered"),
    ("qwen2-1.5b.decode", "unchanged"), ("qwen2-1.5b.decode", "half_batch"),
    ("qwen2-1.5b.decode", "altered")])
def test_serving_faults_are_caught(workload, kind, monkeypatch):
    _serving_fault(workload, kind, monkeypatch)
    # seed 2: one of the decode cell's checked sequences lies in the
    # second half of its batch of 4
    assert not tiny.run(workload, seed=2)["correct"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(workload, seed):
    """The reference in fp8 in the program's place fails a limit."""
    ctx = tiny.context(workload, seed=seed)
    cell = harness.kind_module(ctx.mix["kind"]).Cell(ctx)
    cell.setup()
    cell.window(1.0)
    cell.release()
    assert harness.all_within(cell.check())
    assert not harness.all_within(harness.limited(cell.control(),
                                                  ctx.limits))
