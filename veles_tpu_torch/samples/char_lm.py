"""Character-LM sample — a decoder-only transformer on token sequences.

Port of ``veles_tpu/samples/char_lm.py``: trains a causal transformer on
synthetic structured sequences (a cyclic grammar from the pinned
"charlm_synth" stream, bit-equal to the reference's, so the loss is
provably reducible) or on a real byte-level text file, through the same
Repeater → loader → trainer → Decision cycle.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.ops.nn_units import NNWorkflow
from veles_tpu_torch.ops.transformer import (TransformerDecision,
                                             TransformerTrainer,
                                             trainer_sample_tokens)
from veles_tpu_torch.samples import make_trainer_sample
from veles_tpu_torch.workflow import Repeater


class CharSequenceLoader(FullBatchLoader):
    """Token sequences for the LM: real text when ``text_path`` points at
    a file (byte-level, vocab 256, overlapping seq_len windows, the last
    1/8 of the file held out as validation), synthetic otherwise: each
    sequence cycles ``t[i+1] = (t[i] + step) % vocab`` with a step drawn
    per sequence."""

    def __init__(self, workflow, n_train=512, n_valid=128, seq_len=64,
                 vocab=32, text_path=None, **kwargs):
        super().__init__(workflow, **kwargs)
        self.n_train = n_train
        self.n_valid = n_valid
        self.seq_len = seq_len
        self.vocab = vocab
        self.text_path = text_path
        self.has_labels = False

    def _load_text(self):
        raw = numpy.fromfile(self.text_path, numpy.uint8)
        if len(raw) < 2 * self.seq_len:
            raise ValueError("%s: %d bytes < 2 windows of seq_len %d"
                             % (self.text_path, len(raw), self.seq_len))
        self.vocab = 256
        split = len(raw) - max(len(raw) // 8, self.seq_len)

        def windows(chunk, cap):
            # the stride spreads the cap over the whole chunk
            span = len(chunk) - self.seq_len
            n = min(max(span // max(self.seq_len // 2, 1) + 1, 1), cap)
            stride = max(span // max(n - 1, 1), 1) if n > 1 else 1
            return numpy.stack([chunk[i * stride:i * stride + self.seq_len]
                                for i in range(n)])

        train = windows(raw[:split], self.n_train)
        valid = windows(raw[split:], self.n_valid)
        self.original_data.reset(numpy.concatenate(
            [valid, train]).astype(numpy.int32))
        self.class_lengths = [0, len(valid), len(train)]
        self.info("text corpus %s: %d bytes -> %d train / %d valid "
                  "windows of %d (byte-level vocab 256)",
                  os.path.basename(str(self.text_path)), len(raw),
                  len(train), len(valid), self.seq_len)

    def load_data(self):
        if self.text_path:
            # an explicit corpus path never falls back to synthetic data
            if not os.path.exists(str(self.text_path)):
                raise FileNotFoundError("char_lm text_path %r does not exist"
                                        % (self.text_path,))
            self._load_text()
            return
        stream = prng.get("charlm_synth", pinned=True)
        total = self.n_train + self.n_valid
        starts = stream.randint(0, self.vocab, total)
        steps = stream.randint(1, 5, total)
        idx = numpy.arange(self.seq_len)
        data = (starts[:, None] + steps[:, None] * idx[None, :]) % self.vocab
        self.original_data.reset(data.astype(numpy.int32))
        self.class_lengths = [0, self.n_valid, self.n_train]


class CharLMWorkflow(NNWorkflow):
    def __init__(self, workflow=None, name=None, loader_config=None,
                 trainer_config=None, decision_config=None, **kwargs):
        super().__init__(workflow, name=name, **kwargs)
        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)

        self.loader = CharSequenceLoader(self, name="loader",
                                         **(loader_config or {}))
        self.loader.link_from(self.repeater)

        self.trainer = TransformerTrainer(self, name="trainer",
                                          **(trainer_config or {}))
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"),
                                ("mask", "minibatch_mask"),
                                "minibatch_class")

        self.decision = TransformerDecision(self, name="decision",
                                            **(decision_config or {}))
        self.decision.link_from(self.trainer)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "minibatch_size", "last_minibatch",
                                 "class_lengths", "epoch_number")
        self.decision.link_attrs(self.trainer, "metrics")

        self.repeater.link_from(self.decision)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete


def default_config():
    # a real text corpus is byte-level, so the default vocab follows the
    # data source (raw-dict probing: a dotted read would create a phantom
    # node that defaults() then refuses to overwrite)
    loader_node = root.char_lm.__dict__.get("loader")
    text = (loader_node.__dict__.get("text_path")
            if loader_node is not None else None)
    vocab = 256 if isinstance(text, str) and text else 32
    root.char_lm.defaults({
        "loader": {"minibatch_size": 64, "n_train": 512, "n_valid": 128,
                   "seq_len": 64, "vocab": vocab, "text_path": None},
        "trainer": {"vocab": vocab, "d_model": 64, "n_heads": 4,
                    "n_layers": 2, "max_len": 64, "learning_rate": 1e-3},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
    })
    return root.char_lm


build, train, run = make_trainer_sample("char_lm", CharLMWorkflow,
                                        default_config)


def sample_tokens(wf, prompt, n_new=32, temperature=0.0, seed=0):
    """Continue token sequences with the trained model: KV-cached
    decoding on the trainer's device, greedy by default, sampled at
    ``temperature`` > 0 under ``seed``.  ``prompt``: (batch, s) ints;
    returns (batch, s + n_new) numpy int32."""
    return trainer_sample_tokens(wf.trainer, prompt, n_new=n_new,
                                 temperature=temperature, seed=seed)
