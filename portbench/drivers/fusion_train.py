"""The lazy-fusion classifier's training, as ``FusionEngine.fit`` runs its epochs.

Set-up writes the cached features and labels, builds one ``FusionEngine``
with the benchmark's weights and its AdamW, and runs the first epoch
through the window's own loop: ``epoch_batches``, a ``PrefetchLoader``
over a ``LazyFeatureDataset``, ``accumulate_gradients`` and
``apply_gradients`` a step. Its first three steps are the ones the check
follows (their losses, the first gradient as AdamW's first moment holds it,
the parameters after the third); the rest of the epoch warms the other
length buckets. The window then runs whole epochs on the same engine.
Left out of the window: the per-epoch dev evaluation and checkpoint writes,
which on a real corpus come once per several hundred steps.

A traffic file for this driver gives: ``dtype``;
``bucket_window`` and ``bucket_quantum`` (the engine's); ``corpus``
(``utterances``, ``seconds`` [lo, hi], ``class_shares``, ``modalities``:
each a ``name``, ``dim`` and either ``hop`` (speech: ceil(samples / hop)
frames) or ``rows`` (text)); ``trace_seconds``. The configuration file's
``fusion`` block gives the classifier and its optimizer.
"""

from __future__ import annotations

import os
import statistics
import sys
from collections import defaultdict

import numpy as np
import torch

from .. import corpus, flops, weights
from ..reference import fusion as ref
from ..reference.common import Ops, exact_float32
from ..weights import sub_seed

CHECKED_STEPS = 3


def leaf_gaps(prog, refs):
    """Per leaf |a - b| / max(b, the median b) over the norms of each leaf."""
    med = statistics.median(refs.values())
    return {k: abs(prog[k] - b) / max(b, med) for k, b in refs.items()}


def moved(grads):
    """The elements whose first gradient in the reference is above a
    thousandth of the median leaf's root-mean-square gradient: the others
    (a key's bias under softmax, all but zero) move under Adam by round-off
    alone, in either direction."""
    scale = statistics.median(norm(g) / g.numel() ** 0.5 for g in grads.values())
    return {k: g.abs() >= 1e-3 * scale for k, g in grads.items()}


def norm(t) -> float:
    """A leaf's norm, summed in float64: a float32 sum over millions of
    elements is off by more than the gaps compared."""
    return float(t.double().norm())


def change_norms(changes, keep):
    return {k: norm(changes[k][m]) for k, m in keep.items() if m.any()}


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.fz = self.cfg["fusion"]
        self.tr = run.cell.traffic
        self.device = torch.device(run.device)
        self.recording = self.tracing = False
        self.trace_bounds = defaultdict(float)
        self.window_flops = 0.0
        self.attempted = self.failed = 0
        self.epoch = 0
        self.batches = iter(())
        self.loss = None

    def _shapes(self):
        return ref.param_shapes(self.dims, self.fz["fusion_hidden_dim"], self.fz["num_emotions"])

    def setup(self):
        from interspeech_ser_tpu_torch.train.data import LazyFeatureDataset
        from interspeech_ser_tpu_torch.train.engine import EngineOptions, FusionEngine
        from interspeech_ser_tpu_torch.utils import labels as L
        from interspeech_ser_tpu_torch.utils.config import FusionConfig

        run, fz, tr = self.run, self.fz, self.tr
        data = corpus.features(os.path.join(run.workdir, "features"), tr, run.seed, self.device)
        self.data = data
        self.dims = [m["dim"] for m in tr["corpus"]["modalities"]]
        self.fcfg = FusionConfig(
            wav_dir="", txt_dir="", lazy_dir1=data["dirs"][0], lazy_dir2=data["dirs"][1], label_path="",
            feat1_dim=self.dims[0], feat2_dim=self.dims[1], epochs=fz["epochs"], lr=fz["lr"],
            model_path=os.path.join(run.workdir, "model"), batch_size=fz["batch_size"], accum_step=1,
            use_balanced_batch=fz["use_balanced_batch"], use_focalloss=fz["use_focalloss"],
            fusion_hidden_dim=fz["fusion_hidden_dim"], num_emotions=fz["num_emotions"], dropout=fz["dropout"])
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # as fit sets them
        self.engine_seed = sub_seed(run.seed, "engine")
        opts = EngineOptions(bucket_window=tr["bucket_window"], bucket_quantum=tr["bucket_quantum"])
        self.engine = FusionEngine(self.fcfg, seed=self.engine_seed, device=self.device, options=opts)
        p0 = weights.make(self._shapes(), run.seed, self.device)
        self.engine.model.load_state_dict(p0, strict=True)
        rows = [dict(FileName=n, **{c: float(v) for c, v in zip(L.CLASSES, lab)})
                for n, lab in zip(data["names"], data["labels"])]
        self.ds = LazyFeatureDataset(L.column(rows, "FileName"), L.matrix(rows, L.CLASSES), self.fcfg.lazy_dirs,
                                     self.dims)
        self.class_w = torch.from_numpy(L.class_weights(rows)).to(self.device)
        self.engine.optimizer = self.engine.make_optimizer()

        # the first epoch: steps 1-3 for the check, the rest warms the other buckets
        self.losses, self.grad_norms, self.changes = [], {}, {}
        named = dict(self.engine.model.named_parameters())
        n_steps = 0
        while True:
            n_steps += 1
            self.step()
            if n_steps <= CHECKED_STEPS:
                self.losses.append(float(self.loss))
            if n_steps == 1:
                state = self.engine.optimizer.state  # a leaf the step did not reach has no moment: 0
                self.grad_norms = {k: float(state[p]["exp_avg"].double().norm()) / 0.1 if "exp_avg" in state.get(p, {})
                                   else 0.0 for k, p in named.items()}
            if n_steps == CHECKED_STEPS:
                self.changes = {k: (p.detach() - p0[k]).cpu() for k, p in named.items()}
                del p0
            if self.pass_done() and n_steps >= CHECKED_STEPS:
                break
        self.finish()
        print(f"[portbench] {run.cell.name}: {len(self.ds)} rows, set-up ran {n_steps} steps", file=sys.stderr)

    # -- the window ------------------------------------------------------------

    def pass_done(self) -> bool:
        """The epoch is over."""
        return self.pending == 0

    def _next_batch(self):
        from interspeech_ser_tpu_torch.train.data import PrefetchLoader, epoch_batches
        from interspeech_ser_tpu_torch.train.engine import cosine_epoch_lr

        try:
            return next(self.batches)
        except StopIteration:
            pass
        eng, cfg = self.engine, self.fcfg
        with self.run.spans("epoch_start"):
            self.lr = cosine_epoch_lr(cfg.lr, self.epoch % cfg.epochs, cfg.epochs)
            idx = epoch_batches(self.ds, cfg.batch_size, eng.rng, bucket_window=eng.opt.bucket_window)
            loader = PrefetchLoader(self.ds, idx, cfg.batch_size, eng.opt.bucket_quantum)
            self.pending = len(loader)
            self.batches = iter(loader)
            self.epoch += 1
        return next(self.batches)

    def _bound(self, batch) -> None:
        H = self.fz["fusion_hidden_dim"]
        for m in batch.masks:
            valid, (B, T) = 2 * int(m.sum()), m.shape
            self.trace_bounds["K3"] += flops.k3_seconds(valid, 2 * B, T, H)
            self.trace_bounds["K3b"] += flops.k3b_seconds(valid, 2 * B, T, H)

    def step(self) -> int:
        spans = self.run.spans
        with spans("batch_wait"):
            batch = self._next_batch()
        self.pending -= 1
        with spans("step"):
            self.loss, _ = self.engine.accumulate_gradients(batch, self.class_w)
            self.engine.apply_gradients(self.lr, 1)
        rows = int(batch.sample_mask.sum())
        if self.tracing:
            self._bound(batch)
        if self.recording:
            lengths = [m.sum(axis=1).astype(int).tolist() for m in batch.masks]
            self.window_flops += flops.fusion_step_flops(lengths[0], lengths[1], self.dims,
                                                         self.fz["fusion_hidden_dim"], self.fz["num_emotions"])
            self.attempted += rows
        return rows

    def finish(self) -> int:
        if self.loss is not None:
            float(self.loss)  # the readback of the last step
        return 0

    def end_to_end(self, window, setup_s):
        return {"train_samples_per_s": window["units"] / window["seconds"], "setup_s": setup_s}

    # -- the check ---------------------------------------------------------------

    def free(self):
        self.batches = iter(())
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, ops):
        """The reference's first steps -> (losses, first gradients, changes), on the host."""
        p0 = weights.make(self._shapes(), self.run.seed, self.device)
        dirs, names = self.data["dirs"], self.data["names"]
        sizes = np.asarray([os.path.getsize(os.path.join(dirs[0], n.replace(".wav", ".pt"))) for n in names])
        order = ref.epoch_order(self.engine_seed, sizes, self.fz["batch_size"], self.tr["bucket_window"])
        batches = []
        for idx in order[:CHECKED_STEPS]:
            rows = [[torch.load(os.path.join(d, names[i].replace(".wav", ".pt")), weights_only=True).to(self.device)
                     for d in dirs] for i in idx]
            feats, masks = ref.collate(rows, self.tr["bucket_quantum"], self.device)
            batches.append((feats, masks, torch.from_numpy(self.data["labels"][idx]).to(self.device)))
        class_w = torch.from_numpy(ref.class_weights(self.data["labels"])).to(self.device)
        lr = ref.cosine_lr(self.fz["lr"], 0, self.fz["epochs"])
        gen = torch.Generator(device=self.device).manual_seed(self.engine_seed)
        with exact_float32():
            losses, g1, p3 = ref.train(p0, batches, class_w, lr, self.fz["dropout"], gen, ops)
        return losses, {k: g.cpu() for k, g in g1.items()}, {k: (p3[k] - p0[k]).cpu() for k in p0}

    @staticmethod
    def _numbers(losses, grad_norms, changes, r_losses, r_grads, r_changes):
        """The three numbers compared: each step's loss, the first gradient's
        norm by the worst leaf, and the change's norm by the worst leaf over
        the elements that ``moved`` keeps."""
        keep = moved(r_grads)
        return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
                "grad_norm_gap": max(leaf_gaps(grad_norms, {k: norm(g) for k, g in r_grads.items()}).values()),
                "change_norm_gap": max(leaf_gaps(change_norms(changes, keep), change_norms(r_changes, keep)).values())}

    def check(self):
        r = self._reference(Ops())
        got = self._numbers(self.losses, self.grad_norms, self.changes, *r)
        print(f"[portbench] losses {self.losses} vs the reference's {r[0]}", file=sys.stderr)
        readings = dict(got)
        if self.run.control:
            losses, grads, changes = self._reference(Ops(tf32=True))
            grad_norms = {k: norm(g) for k, g in grads.items()}
            readings.update({f"control.{k}": v for k, v in self._numbers(losses, grad_norms, changes, *r).items()})
        limits = self.run.cell.limits
        return [(k, v, limits[k]) for k, v in got.items()], readings
