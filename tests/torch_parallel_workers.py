"""Rank workers of the port's multi-device tests (``tests/test_torch_parallel*.py``).

This module imports torch and the port, never jax: the ranks are fresh
processes (``torch.multiprocessing`` spawn) that join a gloo group through a
``file://`` init, run a dict of tasks and save what each returned to
``<out_dir>/rank<r>.pt``. The test process runs the same task functions
without a process group for the one-rank results. Every task returns CPU
tensors, numbers and the collective audit of what it ran.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from interspeech_ser_tpu_torch.parallel import audit  # noqa: E402
from interspeech_ser_tpu_torch.parallel import mesh as M  # noqa: E402
from interspeech_ser_tpu_torch.utils import device as D  # noqa: E402


def _cpu_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _silent(*args, **kwargs) -> None:
    pass


# -- mesh units ----------------------------------------------------------------


def gather_losses(seed: int = 3, rows: int = 7) -> dict:
    """The gradients of CKA, diff-F1, dynamic-alpha focal and CCC through
    ``gather_rows`` (each rank holds its rows of a seeded global batch padded
    to a mesh multiple) -> the rank's rows' gradients, the losses and the
    audit of the three gathers and backwards."""
    from interspeech_ser_tpu_torch.train import losses

    mesh = M.make_mesh()
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(rows, 8, generator=g)
    a, b = torch.randn(rows, 6, generator=g), torch.randn(rows, 5, generator=g)
    y = torch.randint(0, 8, (rows,), generator=g)
    labels = torch.nn.functional.one_hot(y, 8).float()
    smask = (torch.arange(rows) < rows - 1).float()
    attrs = torch.rand(rows, 3, generator=g)
    out = {}
    with audit.collective_audit() as rec:
        for name, fn in (
            ("cka", lambda z, u, v: losses.cka_loss(u, v)),
            ("diff_f1", lambda z, u, v: losses.diff_f1_loss(z, labels)),
            ("focal", lambda z, u, v: losses.focal_loss(z, y, alpha=1.0, gamma=2.0, dynamic_alpha=True,
                                                         sample_mask=smask)),
            ("ccc", lambda z, u, v: losses.ccc_loss(z[:, :3], attrs, smask)),
        ):
            z, u, v = (M.shard_batch(mesh, t).clone().requires_grad_() for t in (logits, a, b))
            loss = fn(*(M.gather_rows(mesh, t, rows) for t in (z, u, v)))
            loss.backward()
            out[name] = {"loss": float(loss.detach()),
                         "grads": [torch.zeros_like(t) if t.grad is None else t.grad.clone() for t in (z, u, v)]}
    out["audit"] = rec
    out["rows"] = M.batch_sharding(mesh, rows)
    return out


def sync_bn(seed: int = 4, rows: int = 6) -> dict:
    """The x-vector net and the proto trainers' reference encoder in training
    mode on the rank's rows of a seeded batch: their outputs, BatchNorm
    running statistics and parameter gradients (of a loss on the gathered
    outputs, summed over the ranks), and the audit."""
    from interspeech_ser_tpu_torch.models.xvector import XVector
    from interspeech_ser_tpu_torch.ops.batch_norm import sync
    from interspeech_ser_tpu_torch.train.proto_engine import BidirectionalReferenceEncoder

    mesh = M.make_mesh()
    g = torch.Generator().manual_seed(seed)
    out = {}
    with audit.collective_audit() as rec:
        for name, make, x in (
            ("xvector", lambda: XVector(), torch.randn(rows, 60, 24, generator=g) * 2 + 1),
            ("reference", lambda: BidirectionalReferenceEncoder(16, 8), torch.randn(rows, 32, 16, generator=g)),
        ):
            torch.manual_seed(seed)
            net = sync(make(), mesh).train()
            xs = M.shard_batch(mesh, x)
            emb = net(xs) if name == "reference" else net(xs, torch.full((xs.shape[0],), 60))
            full = M.gather_rows(mesh, emb, rows)
            (full.square().mean() + full.mean(0).square().sum()).backward()
            M.all_reduce_grads(mesh, net.parameters())
            out[name] = {"emb": full.detach().clone(), "state": _cpu_state(net),
                         "grads": {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}}
    out["audit"] = rec
    return out


# -- extraction ----------------------------------------------------------------


def extract_speech(model_dir: str, wav_dir: str, save_path: str, dtype: str = "float32",
                   model_parallel: int = 1, token_budget: int = None) -> dict:
    from interspeech_ser_tpu_torch.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_speech_encoder

    model, cfg, do_normalize = build_speech_encoder(model_dir, dtype=dtype)
    pipe = SpeechExtractionPipeline(model, cfg, do_normalize=do_normalize, token_budget=token_budget,
                                    num_workers=2, device="cpu", model_parallel=model_parallel)
    with audit.collective_audit() as rec:
        stats = pipe.run(wav_dir, save_path)
    return {"stats": dataclasses.asdict(stats), "audit": rec, "mesh": pipe.mesh.shape,
            "layers": cfg.num_layers}


def extract_whisper(model_dir: str, wav_dir: str, save_path: str, batch_size: int = 2) -> dict:
    from interspeech_ser_tpu_torch.extract.pipeline import WhisperExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_whisper_encoder

    model, cfg = build_whisper_encoder(model_dir)
    pipe = WhisperExtractionPipeline(model, cfg, batch_size=batch_size, num_workers=2, device="cpu")
    with audit.collective_audit() as rec:
        stats = pipe.run(wav_dir, save_path)
    return {"stats": dataclasses.asdict(stats), "audit": rec}


def _word_tokenize(max_length: int, vocab: int):
    def tokenize(texts):
        ids = np.ones((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, t in enumerate(texts):
            toks = [0] + [3 + sum(map(ord, w)) % (vocab - 3) for w in str(t).split()][: max_length - 2] + [2]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    return tokenize


def extract_text(model_dir: str, csv_path: str, save_path: str, batch_size: int = 3, max_length: int = 12) -> dict:
    from interspeech_ser_tpu_torch.extract.pipeline import TextExtractionPipeline
    from interspeech_ser_tpu_torch.models.loader import build_roberta
    from interspeech_ser_tpu_torch.preprocess_cli import read_transcripts

    model, cfg = build_roberta(model_dir)
    names, texts = read_transcripts(csv_path)
    pipe = TextExtractionPipeline(model, cfg, _word_tokenize(max_length, cfg.vocab_size), batch_size=batch_size,
                                  num_workers=2, device="cpu")
    with audit.collective_audit() as rec:
        stats = pipe.run(names, texts, save_path)
    return {"stats": dataclasses.asdict(stats), "audit": rec}


def preprocess(argv: list) -> dict:
    """``preprocess_cli.main(argv)`` (``--device cpu`` appended)."""
    from interspeech_ser_tpu_torch import preprocess_cli

    with audit.collective_audit() as rec:
        preprocess_cli.main(list(argv) + ["--device", "cpu"])
    return {"audit": rec}


# -- trainers ------------------------------------------------------------------


def fusion_fit(config_path: str, model_path: str, init_path: str = None, seed: int = 7, **options) -> dict:
    """``FusionEngine.fit`` from the given initial state dict -> each epoch's
    dev macro-F1 (the dim task: its dev loss), every micro-batch's loss, the
    final parameters, the fit's audit and the trainable element count."""
    from interspeech_ser_tpu_torch.train import engine as E
    from interspeech_ser_tpu_torch.utils import labels as L
    from interspeech_ser_tpu_torch.utils.config import load_fusion_config

    cfg = dataclasses.replace(load_fusion_config(config_path), model_path=model_path)
    rows = L.load_merged(cfg.label_path, cfg.txt_dir)
    eng = E.FusionEngine(cfg, seed=seed, device="cpu", options=E.EngineOptions(**options))
    if init_path:
        eng.model.load_state_dict(torch.load(init_path, weights_only=True))
    f1s, losses = [], []
    evaluate, accumulate = eng.evaluate, eng.accumulate_gradients

    def rec_eval(*a, **kw):
        res = evaluate(*a, **kw)
        f1s.append(res.get("macro_f1", res["loss"]))
        return res

    def rec_acc(*a, **kw):
        out = accumulate(*a, **kw)
        losses.append(float(out[0]))
        return out

    eng.evaluate, eng.accumulate_gradients = rec_eval, rec_acc
    with audit.collective_audit() as rec:
        best = eng.fit(L.split(rows, "Train"), L.split(rows, "Development"))
    return {"f1": f1s, "losses": losses, "params": _cpu_state(eng.model), "best_epoch": best["epoch"],
            "audit": rec, "trainable": audit.param_elements(eng.model)}


def lora_fit(model_dir: str, init_path: str, wavs: list, labels: list, n_train: int, batch_size: int = 3,
             epochs: int = 1, lr: float = 5e-3, head_dropout: bool = True) -> dict:
    """``LoRAFTEngine.train_epochs`` from the given factors and head."""
    from interspeech_ser_tpu_torch.models import lora
    from interspeech_ser_tpu_torch.train.lora_engine import LoRAFTEngine

    eng = LoRAFTEngine(model_dir, rank=2, num_emotions=4, device="cpu")
    init = torch.load(init_path, weights_only=True)
    eng._set_lora(lora.lora_from_state_dict(init["lora"]))
    eng.head.load_state_dict(init["head"])
    if not head_dropout:
        eng.head.dropout_p = 0.0
    wavs = [np.asarray(w, np.float32) for w in wavs]
    labels = np.asarray(labels)
    with audit.collective_audit() as rec:
        res = eng.train_epochs(wavs[:n_train], labels[:n_train], wavs[n_train:], labels[n_train:], epochs=epochs,
                               batch_size=batch_size, lr=lr, log=_silent)
    return {"lora": lora.lora_state_dict(eng.lora), "head": _cpu_state(eng.head), "losses": res["losses"],
            "history": res["history"], "audit": rec, "trainable": audit.param_elements(eng.trainable()),
            "encoder": audit.param_elements(eng.model.parameters())}


def baseline_fit(model_dir: str, init_path: str, label_path: str, audio_path: str, model_path: str,
                 task: str = "cat", dropout: float = 0.0, batch_size: int = 6, accumulation_steps: int = 3,
                 epochs: int = 1, lr: float = 1e-3, loss_mode: str = "wce") -> dict:
    from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine

    eng = BaselineEngine(model_dir, task=task, head_dim=16, seed=100, dropout=dropout, loss_mode=loss_mode,
                         device="cpu")
    if init_path:
        init = torch.load(init_path, weights_only=True)
        for name in ("ssl", "pool", "head"):
            getattr(eng, name).load_state_dict(init[name])
    with audit.collective_audit() as rec:
        best = eng.fit(label_path, audio_path, model_path, batch_size=batch_size,
                       accumulation_steps=accumulation_steps, epochs=epochs, lr=lr, log=_silent)
    return {"params": {f"{n}.{k}": v for n in ("ssl", "pool", "head") for k, v in _cpu_state(getattr(eng, n)).items()},
            "dev_losses": best["dev_losses"], "dev_preds": best["dev_preds"], "audit": rec,
            "trainable": audit.param_elements(eng.trainable())}


def joint_fit(corpus: str, variant: str, model_path: str, batch_size: int = 4, accumulation_steps: int = 2,
              epochs: int = 1, lr: float = 1e-3, head_dim: int = 8) -> dict:
    from interspeech_ser_tpu_torch.train.joint_engine import VARIANTS, JointEngine

    eng = JointEngine(os.path.join(corpus, "hf_wavlm"), os.path.join(corpus, "hf_roberta"),
                      _word_tokenize(16, 64), VARIANTS[variant], head_dim=head_dim, seed=5, device="cpu")
    with audit.collective_audit() as rec:
        best = eng.fit(os.path.join(corpus, "labels.csv"), os.path.join(corpus, "audio"),
                       os.path.join(corpus, "transcripts.csv"), model_path, batch_size=batch_size,
                       accumulation_steps=accumulation_steps, epochs=epochs, lr=lr, log=_silent)
    trained = [p for p in list(eng.head.parameters()) + eng.encoder_params() if p.requires_grad]
    return {"head": _cpu_state(eng.head), "dev_losses": best["dev_losses"], "audit": rec,
            "trainable": audit.param_elements(trained)}


def text_fit(corpus: str, model_path: str, batch_size: int = 4, epochs: int = 1, lr: float = 1e-3) -> dict:
    from interspeech_ser_tpu_torch.train.joint_engine import TextOnlyEngine

    eng = TextOnlyEngine(os.path.join(corpus, "hf_roberta"), _word_tokenize(16, 64), seed=5, device="cpu")
    with audit.collective_audit() as rec:
        best = eng.fit(os.path.join(corpus, "labels.csv"), os.path.join(corpus, "transcripts.csv"), model_path,
                       batch_size=batch_size, epochs=epochs, lr=lr, use_focalloss=True, log=_silent)
    return {"head": _cpu_state(eng.cls_head), "dev_losses": best["dev_losses"], "audit": rec,
            "trainable": audit.param_elements(eng.parameters())}


def proto_only_fit(net: str, init_path: str, lazy_dir: str, names: list, labels: list, n_train: int,
                   C: int, U: int, U_val: int, model_path: str, epochs: int = 2, lr: float = 5e-3,
                   dropout: bool = False, ce_mode: bool = False) -> dict:
    """``ProtoOnlyEngine.fit`` of a ``ProtoSERNet`` (``net='ser'``) or a
    ``BidirectionalReferenceEncoder`` (``'reference'``, log-mel-shaped lazy
    features) from the given state dict."""
    from interspeech_ser_tpu_torch.train import proto_engine as P

    model = P.ProtoSERNet(12, 16, 4 if ce_mode else 0, 1) if net == "ser" else P.BidirectionalReferenceEncoder(12, 8)
    model.load_state_dict(torch.load(init_path, weights_only=True))
    eng = P.ProtoOnlyEngine(model, C, U, U_val, seed=3, ce_mode=ce_mode, val_batch_size=8, device="cpu")
    if not dropout:
        eng.generator = None
    labels = np.asarray(labels)
    tr = P.LazyProtoDataset(names[:n_train], labels[:n_train], lazy_dir)
    va = P.LazyProtoDataset(names[n_train:], labels[n_train:], lazy_dir)
    with audit.collective_audit() as rec:
        best = eng.fit(tr, va, epochs=epochs, lr=lr, model_path=model_path, log=_silent)
    return {"state": _cpu_state(eng.net), "best": best, "audit": rec,
            "trainable": audit.param_elements(eng.net)}


def proto_angular_fit(init_path: str, lazy_dir: str, names: list, labels: list, C: int, U: int,
                      epochs: int = 2, lr: float = 1e-3, softmax: bool = False) -> dict:
    from interspeech_ser_tpu_torch.train import data as pdata
    from interspeech_ser_tpu_torch.train import proto_engine as P

    y = np.eye(8, dtype=np.float32)[np.asarray(labels)]
    ds = pdata.LazyFeatureDataset(names, y, [lazy_dir], [12])
    eng = P.ProtoAngularEngine(12, num_classes=C, utter_per_class=U, embedding_dim=6, use_softmax_proto=softmax,
                               seed=3, device="cpu")
    eng.model.load_state_dict(torch.load(init_path, weights_only=True))
    with audit.collective_audit() as rec:
        res = eng.fit(ds, np.asarray(labels), epochs=epochs, lr=lr, log=_silent)
    return {"state": _cpu_state(eng.model), "result": res, "emb": eng.embed(ds, batch_size=16), "audit": rec,
            "trainable": audit.param_elements(eng.model)}


def xvector_fit(init_path: str, label_path: str, audio_path: str, model_path: str, batch_size: int = 4,
                accumulation_steps: int = 2, epochs: int = 1, lr: float = 1e-4) -> dict:
    from interspeech_ser_tpu_torch.baseline.xvector_engine import XVectorEngine

    eng = XVectorEngine(head_dim=16, seed=3, device="cpu")
    init = torch.load(init_path, weights_only=True)
    eng.xvector.load_state_dict(init["xvector"])
    eng.head.load_state_dict(init["head"])
    eng.generator = None
    with audit.collective_audit() as rec:
        best = eng.fit(label_path, audio_path, model_path, batch_size=batch_size,
                       accumulation_steps=accumulation_steps, epochs=epochs, lr=lr, log=_silent)
    return {"xvector": _cpu_state(eng.xvector), "head": _cpu_state(eng.head), "dev_losses": best["dev_losses"],
            "audit": rec, "trainable": audit.param_elements(eng.parameters())}


TASKS = {f.__name__: f for f in (gather_losses, sync_bn, extract_speech, extract_whisper, extract_text, preprocess,
                                 fusion_fit, lora_fit, baseline_fit, joint_fit, text_fit, proto_only_fit,
                                 proto_angular_fit, xvector_fit)}


def run_tasks(tasks: dict) -> dict:
    """{name: (task function name, kwargs)} -> {name: its result}; a
    ``model_parallel`` in the kwargs of a task runs it on that mesh."""
    return {name: TASKS[fn](**kwargs) for name, (fn, kwargs) in tasks.items()}


def _rank_main(rank: int, world: int, init_file: str, tasks, out_dir: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    D.init_distributed("cpu", init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        torch.save(run_tasks(tasks), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        D.teardown()


def spawn(world: int, tasks: dict, out_dir: str, meanwhile=None):
    """Run ``tasks`` on ``world`` gloo ranks -> each rank's results, and what
    ``meanwhile()`` returned: it runs in this process while the ranks work.
    A rank that raises fails the call."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    init_file = tempfile.mktemp(dir=out_dir, prefix="init_")
    ctx = mp.spawn(_rank_main, args=(world, init_file, tasks, out_dir), nprocs=world, join=False)
    try:
        extra = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    return (ranks, extra) if meanwhile is not None else ranks
