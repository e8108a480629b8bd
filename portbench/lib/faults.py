"""Faults planted underneath the timed path, to show that ``correct``
catches them: each takes a pytest-style ``monkeypatch`` (anything with
``setattr(obj, name, value)`` that undoes it later) and breaks one thing.
The benchmark's own runs plant none; ``tests/test_portbench_faults.py``
and ``tools/calibrate.py --fault`` do."""

import torch


def state_unchanged(monkeypatch):
    """The step computes its loss and returns without a gradient or an
    update."""
    from privacy_preserve_federated_asr_tpu_torch.train import steps

    def no_update(state, loss, metrics):
        state.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = torch.zeros(())
        return out

    monkeypatch.setattr(steps, "_apply_update", no_update)


def half_batch(monkeypatch):
    """The CTC loss over the first half of the rows, scaled to the batch."""
    from privacy_preserve_federated_asr_tpu_torch.models import objectives

    ctc = objectives.ctc_loss

    def half(log_probs, labels, lengths, label_lengths, **kw):
        nll = ctc(log_probs, labels, lengths, label_lengths, **{**kw, "reduction": "none"})
        b = nll.shape[0]
        return nll[: b // 2].sum() * (b / (b // 2))

    monkeypatch.setattr(objectives, "ctc_loss", half)


def label_altered(monkeypatch):
    """The feed hands the step one row whose first labels are other
    characters."""
    from privacy_preserve_federated_asr_tpu_torch.train import trainer

    gather = trainer.gather_features

    def altered(*args):
        fb = gather(*args)
        lab = fb.labels.clone()
        lab[0, :4] = (lab[0, :4] - 4 + 7) % 28 + 4
        fb.labels = lab
        return fb

    monkeypatch.setattr(trainer, "gather_features", altered)


def token_altered(monkeypatch):
    """Greedy decoding puts the reference's worst token at one frame of
    every row."""
    from privacy_preserve_federated_asr_tpu_torch.serving import engine

    greedy = engine.greedy_ids

    def altered(logits, frame_mask, blank_id=0):
        ids = greedy(logits, frame_mask, blank_id)
        rows = torch.arange(ids.shape[0])
        mid = (frame_mask.sum(1) // 2).long()
        ids[rows, mid] = logits[rows, mid].argmin(-1)
        return ids

    monkeypatch.setattr(engine, "greedy_ids", altered)


def serve_half_batch(monkeypatch):
    """The engine runs the first half of each batch and hands its answers
    to the other half too."""
    from privacy_preserve_federated_asr_tpu_torch.serving.engine import InferenceEngine

    chunk = InferenceEngine._infer_chunk

    def half(self, arrays):
        keep = max(len(arrays) // 2, 1)
        got = chunk(self, arrays[:keep])
        return (got * 2)[: len(arrays)]

    monkeypatch.setattr(InferenceEngine, "_infer_chunk", half)


FAULTS = {"none": None, "state_unchanged": state_unchanged, "half_batch": half_batch,
          "label_altered": label_altered, "token_altered": token_altered,
          "serve_half_batch": serve_half_batch}
