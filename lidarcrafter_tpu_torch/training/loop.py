"""The training loop.

Port of the JAX package's ``training/loop.py``: ``Trainer`` for the
unconditional (``nuscenes-unet-uncond``) and the concat-conditioned layout
configs (``nuscenes-box-layout-v6``, ``nuscenes-auto-reg-v2``): factory →
AdamW → train step → EMA → tracker / previews / profiling window →
periodic checkpoints → resume; and its three subclasses, which change only
the build, the loss's extra arguments and the batch: ``FlowTrainer``
(``meanflow-nusc``, the MeanFlow JVP loss), ``ObjectTrainer``
(``nuscenes-object``) and ``LayoutTrainer`` (``nuscenes-layout``, padded
scene-graph batches).  The host reads the loss only when it logs.

Observability as in the JAX loop: ``loss``, ``lr`` and ``sec_per_step``
(``StepTimer``) go to ``log_fn`` and the ``tracker``; every
``steps_save_image`` steps the image branches sample a DDIM preview on the
EMA weights and log its renders (a preview that fails logs
``preview_error`` and training goes on); ``profile_dir`` takes a
``torch.profiler`` trace of steps 4–6.  Under data parallelism
(``parallel``, ``parallel/ddp.py``) each rank trains on its rows of the
global batch, the engine's loss keeps its rows of the global batch's draws
(:meth:`Trainer.rank_rows`), and rank 0 alone logs, previews, profiles and
writes checkpoints.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..draws import Rows
from ..models.graph import MaskedBatchNorm
from ..utils.profiling import StepTimer, start_trace, stop_trace
from ..weights import init_random_
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .factory import build_diffusion_training, build_flow_training, build_layout_training, build_object_training
from .optim import cosine_warmup_schedule, make_optimizer
from .preprocess import preprocess_autoregressive_cond, preprocess_condition_mask, preprocess_x0
from .state import TrainState
from .tracker import render_sample_images
from .train_step import make_train_step


class Trainer:
    """Unconditional / concat-conditioned diffusion trainer on ``device``.

    ``data_iter`` yields collated batches (numpy arrays or tensors) of raw
    ``depth`` / ``reflectance`` (and the layout conditions), which
    :meth:`prepare_batch` turns into the engine's input; a batch that
    carries ``x_0`` is in the engine's format already (the synthetic
    source) and is only moved to the device.  Under ``parallel`` it yields
    this rank's rows of each global batch.
    """

    loss_has_aux = False  # engine.loss returns (loss, aux) instead of loss

    def __init__(
        self,
        cfg,
        data_iter: Iterator[dict],
        output_dir: str | Path | None = None,
        log_fn: Callable[[dict], None] | None = print,
        device: str | torch.device = "cuda",
        tracker=None,
        profile_dir: str | Path | None = None,
        preview_num_steps: int | None = None,
        preview_batch_size: int | None = None,
        parallel=None,
    ):
        self.cfg = cfg
        self.data_iter = data_iter
        self.log_fn = log_fn
        self.device = resolve_device(device) if parallel is None else parallel.device
        self.parallel = parallel
        self.is_main = parallel is None or parallel.is_main
        self.output_dir = Path(output_dir or cfg.training.output_dir)
        self.tracker = tracker
        self.profile_dir = profile_dir
        self.preview_num_steps = preview_num_steps or cfg.diffusion.num_sampling_steps
        self.preview_batch_size = preview_batch_size or cfg.training.batch_size_eval
        models, self.engine, self.lidar_utils = self._build(cfg)
        self.is_cond = isinstance(models, dict)
        self.models = models if self.is_cond else {"model": models}
        t = cfg.training
        self.lr_schedule = cosine_warmup_schedule(t.lr, t.lr_warmup_steps, t.num_steps)
        self.optimizer = make_optimizer(
            lr=t.lr, warmup_steps=t.lr_warmup_steps, num_steps=t.num_steps, b1=t.adam_beta1,
            b2=t.adam_beta2, eps=t.adam_epsilon, weight_decay=t.adam_weight_decay,
            grad_accum_steps=t.gradient_accumulation_steps,
        )
        self.step_fn = make_train_step(
            self.engine, self.optimizer, ema_beta=t.ema_decay, ema_update_every=t.ema_update_every,
            ema_update_after_step=t.lr_warmup_steps * t.gradient_accumulation_steps,
            amp=t.mixed_precision == "bf16", loss_kwargs=self._loss_kwargs(), loss_has_aux=self.loss_has_aux,
            reduce_grads=None if parallel is None else parallel.average_,
        )

    def _build(self, cfg):
        return build_diffusion_training(cfg, self.device)

    def _loss_kwargs(self) -> dict:
        """Extra arguments of every ``engine.loss`` call."""
        return {}

    def init_state(self, seed: int) -> TrainState:
        """Fresh state: seeded random weights as the serving entry points
        draw them (``weights.init_random_``; encoder ``seed``, denoiser
        ``seed + 1``), so a fresh checkpoint serves like the generator of
        the same seed; EMA copies and a zero optimizer state."""
        if self.is_cond:
            init_random_(self.models["cond"], seed)
        init_random_(self.models["model"], seed + int(self.is_cond))
        return TrainState.create(self.models, self.optimizer)

    def prepare_batch(self, batch: dict):
        """Collated batch → engine input on the device."""
        tb = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
        if "x_0" in tb:
            return tb if self.is_cond else tb["x_0"]
        data = self.cfg.data
        x_0 = preprocess_x0(tb, self.lidar_utils, data.train_depth, data.train_reflectance)
        if not self.is_cond:
            return x_0
        input_dict = dict(tb, x_0=x_0)
        if "condition_mask" in tb:
            input_dict["concat_cond"] = preprocess_condition_mask(tb, self.lidar_utils, len(data.class_names))
        if "autoregressive_cond" in tb:
            input_dict["autoregressive_cond"] = preprocess_autoregressive_cond(
                tb["autoregressive_cond"], self.lidar_utils, include_reflectance=False
            )
        return input_dict

    def rank_rows(self, prepared) -> dict:
        """The loss's arguments that name this rank's rows of the global
        batch, whose draws the engine makes whole and cuts to them."""
        x_0 = prepared["x_0"] if self.is_cond else prepared
        return {"rows": self.parallel.rows(x_0.shape[0])}

    def ema_engine(self, state: TrainState):
        """The engine on the EMA copies of the trained modules."""
        modules = {"model": state.ema["model"]}
        if "cond" in state.ema:
            modules["cond_model"] = state.ema["cond"]
        return dataclasses.replace(self.engine, **modules)

    def preview_images(self, state: TrainState, seed: int, batch=None) -> dict:
        """A DDIM sample on the EMA weights (``preview_num_steps`` steps;
        the conditional engines on ``batch``, the last training batch),
        rendered by ``render_sample_images``."""
        engine = self.ema_engine(state)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.is_cond:
            if batch is None:
                return {}
            bs = int(batch["x_0"].shape[0]) if "x_0" in batch else self.preview_batch_size
            sample = engine.sample(batch, bs, self.preview_num_steps, mode="ddim", generator=generator)
        else:
            sample = engine.sample(self.preview_batch_size, self.preview_num_steps, mode="ddim", generator=generator)
        return render_sample_images(sample, self.lidar_utils, train_depth=self.cfg.data.train_depth,
                                    train_reflectance=self.cfg.data.train_reflectance)

    def resume_state(self, resume: str, seed: int) -> TrainState:
        """The state of the checkpoint ``resume`` (weights, EMA, optimizer,
        step); ``'auto'`` takes the newest ``ckpt_*`` in ``output_dir``, or a
        fresh state when there is none."""
        path = latest_checkpoint(self.output_dir) if resume == "auto" else resume
        state = self.init_state(seed)
        if path is None:
            self._log({"resume": "no checkpoint found, fresh start"})
            return state
        state, _ = restore_checkpoint(path, state)
        self._log({"resume": str(path), "step": state.step})
        return state

    def _log(self, record: dict) -> None:
        if self.log_fn is not None and self.is_main:
            self.log_fn(record)

    def train(
        self,
        num_steps: int | None = None,
        seed: int | None = None,
        state: TrainState | None = None,
        checkpoint_every: int | None = None,
        preview_every: int | None = None,
        log_every: int = 50,
        resume: str | None = None,
    ) -> TrainState:
        """Train until ``state.step`` reaches ``num_steps``; log every
        ``log_every`` steps (and steps 1 and 2), preview every
        ``preview_every`` (default ``steps_save_image``; only with a
        tracker), checkpoint every ``checkpoint_every`` to
        ``output_dir/ckpt_{step:010d}``."""
        seed = self.cfg.training.seed if seed is None else seed
        num_steps = num_steps or self.cfg.training.num_steps
        checkpoint_every = checkpoint_every or self.cfg.training.steps_save_model
        preview_every = self.cfg.training.steps_save_image if preview_every is None else preview_every
        if state is None:
            state = self.resume_state(resume, seed) if resume else self.init_state(seed)
        if self.parallel is not None:  # every rank starts from rank 0's state
            self.parallel.broadcast_(state.params() + state.ema_params())
        timer, profiler, prepared = StepTimer(), None, None
        while state.step < num_steps:
            prepared = self.prepare_batch(next(self.data_iter))
            rows = {} if self.parallel is None else self.rank_rows(prepared)
            state, loss = self.step_fn(state, prepared, seed, **rows)
            step = state.step
            timer.tick()
            if self.profile_dir and self.is_main:  # a trace of steps 4-6, past the first steps' warm-up
                if step == 3 and profiler is None:
                    profiler = start_trace()
                elif profiler is not None and step >= 6:
                    self._log({"profile": stop_trace(profiler, self.profile_dir, "train_steps")})
                    profiler = None
            if step % log_every == 0 or step <= 2:
                if self.parallel is not None:
                    loss = self.parallel.mean(loss)
                record = {"step": step, "loss": float(loss),  # the host's only read of the device
                          "lr": self.lr_schedule(step), "sec_per_step": timer.mean}
                self._log(record)
                if self.tracker is not None and self.is_main:
                    self.tracker.log({k: v for k, v in record.items() if k != "step"}, step)
            if self.tracker is not None and self.is_main and preview_every and step % preview_every == 0:
                try:
                    images = self.preview_images(state, seed, prepared)
                    if images:
                        self.tracker.log_images(images, step)
                except Exception as e:  # a preview never stops training
                    self._log({"step": step, "preview_error": str(e)})
            if checkpoint_every and step % checkpoint_every == 0 and self.is_main:
                save_checkpoint(self.output_dir / f"ckpt_{step:010d}", state, self.cfg)
        if profiler is not None:
            self._log({"profile": stop_trace(profiler, self.profile_dir, "train_steps")})
        return state


def _to_device(tree, device: torch.device):
    """numpy arrays / tensors of a nested dict → tensors on ``device``,
    integer indices as int64."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device, torch.int64 if t.dtype == torch.int32 else t.dtype)


class FlowTrainer(Trainer):
    """MeanFlow trainer (``meanflow-nusc``).  The engine's loss returns
    ``(adaptive loss, mse)``; the step trains on the first."""

    loss_has_aux = True

    def _build(self, cfg):
        return build_flow_training(cfg, self.device)

    def preview_images(self, state: TrainState, seed: int, batch=None) -> dict:
        """The one-step MeanFlow sample on the EMA weights, rendered."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.ema_engine(state).sample(batch_size=self.preview_batch_size, generator=generator)
        return render_sample_images(sample, self.lidar_utils, train_depth=self.cfg.data.train_depth,
                                    train_reflectance=self.cfg.data.train_reflectance)


class ObjectTrainer(Trainer):
    """Per-object point diffusion trainer (``nuscenes-object``).
    ``data_iter`` yields ``fg_points`` (B, num_samples, 4) box-frame clouds
    (``norm_fg_points``), ``fg_encoding_box`` (B, 6) and ``fg_class`` (B,);
    ``text_features`` is the (num_class, 512) CLIP class-text table, held
    on the device and fed with every batch."""

    def __init__(self, cfg, data_iter, text_features, **kw):
        super().__init__(cfg, data_iter, **kw)
        self.text_features = torch.as_tensor(np.asarray(text_features), dtype=torch.float32, device=self.device)

    def _build(self, cfg):
        return build_object_training(cfg, self.device)

    def preview_images(self, state, seed, batch=None) -> dict:
        """None: the branch samples points, not range images (the JAX loop's
        base preview fails on them and logs ``preview_error``)."""
        return {}

    def prepare_batch(self, batch: dict) -> dict:
        return {
            "x_0": torch.as_tensor(batch["fg_points"], dtype=torch.float32).to(self.device),
            "fg_encoding_box": torch.as_tensor(batch["fg_encoding_box"], dtype=torch.float32).to(self.device),
            "fg_class": torch.as_tensor(batch["fg_class"]).to(self.device),
            "fg_text_features": self.text_features,
        }


# nuScenes layout scenes carry at most 13 objects besides the ego node; each
# object pair emits up to 5 relationships and each object-ego pair up to 4
MAX_OBJECTS_PER_SCENE = 13
EDGES_PER_SCENE = MAX_OBJECTS_PER_SCENE * (MAX_OBJECTS_PER_SCENE - 1) // 2 * 5 + MAX_OBJECTS_PER_SCENE * 4  # 442


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def pad_layout_batch(collated: dict, max_nodes: int, max_edges: int) -> dict:
    """The decoder side of a collated scene-graph batch
    (``collate_scene_graphs``) → the layout engine's input at fixed node and
    edge budgets, numpy arrays as the JAX package's: padded nodes carry zero
    loss weight (``boxes[:, 20:] = 0``) and scene 0, padded triples point at
    node 0 with ``edge_mask`` False.  The engine's loss is a mean over all
    ``max_nodes`` rows, padded ones included, as in the JAX package."""
    dec = collated["decoder"] if "decoder" in collated else collated
    boxes = np.asarray(dec["boxes"], np.float32)
    objs = np.asarray(dec["objs"], np.int32)
    triples = np.asarray(dec.get("tripltes", dec.get("triples")), np.int32).reshape(-1, 3)
    n, e = len(objs), len(triples)
    if n > max_nodes or e > max_edges:
        raise ValueError(f"batch ({n} nodes, {e} edges) exceeds budgets ({max_nodes}, {max_edges})")
    tf = np.asarray(dec["text_feats"], np.float32)
    rf = np.asarray(dec["rel_feats"], np.float32)

    def pad(a, rows, shape, dtype):
        out = np.zeros((rows, *shape), dtype)
        if len(a):
            out[:len(a)] = a
        return out

    return {
        "boxes": pad(boxes, max_nodes, boxes.shape[1:], np.float32),
        "scene_ids": pad(np.asarray(dec["obj_to_scene"], np.int32), max_nodes, (), np.int32),
        "scenegraph": {
            "objs": pad(objs, max_nodes, (), np.int32),
            "triples": pad(triples, max_edges, (3,), np.int32),
            "text_feats": pad(tf, max_nodes, (tf.shape[1] if tf.ndim == 2 else 512,), np.float32),
            "rel_feats": pad(rf, max_edges, (rf.shape[1] if rf.ndim == 2 else 512,), np.float32),
            "edge_mask": np.arange(max_edges) < e,
        },
    }


def train_running_statistics_(module: torch.nn.Module) -> None:
    """Make the running statistics of every ``MaskedBatchNorm`` in
    ``module`` trained tensors.  The JAX ``LayoutTrainer`` keeps them in the
    parameter tree it differentiates (its ``batch_stats`` collection), and
    the GCNs read them (running-average mode), so they take gradients, the
    clip, AdamW and the EMA like any parameter; nothing updates them with
    batch statistics."""
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.running_mean.requires_grad_(True)
            m.running_var.requires_grad_(True)


class LayoutTrainer(Trainer):
    """Scene-graph → 1D layout trainer (``nuscenes-layout``).  ``data_iter``
    yields collated scene-graph batches (``collate_scene_graphs``), padded
    to node and edge budgets: by default the worst case of
    ``batch_size_train`` scenes, ``_round8(B·14)`` nodes and
    ``_round8(B·442)`` edges.  A batch beyond them grows the budgets (and is
    logged) instead of failing.  Both GCNs run on their running statistics,
    which train as parameters (:func:`train_running_statistics_`).

    Under data parallelism each rank pads its scenes to its share of the
    global budgets, so that the loss, a mean over the padded node budget,
    averages over the ranks to the one-process loss; a rank's noise rows
    are those of its nodes in the global batch's draws, its padded rows
    zeros."""

    def __init__(self, cfg, data_iter, max_nodes: int | None = None, max_edges: int | None = None, **kw):
        B = cfg.training.batch_size_train
        world = 1 if kw.get("parallel") is None else kw["parallel"].world
        nodes = max_nodes or _round8(B * (MAX_OBJECTS_PER_SCENE + 1))
        edges = max_edges or _round8(B * EDGES_PER_SCENE)
        if B % world or nodes % world or edges % world:
            raise ValueError(f"{B} scenes and budgets of {nodes} nodes, {edges} edges do not split over {world} ranks")
        self.max_nodes, self.max_edges = nodes // world, edges // world
        self.real_nodes = None  # nodes of the last batch before padding
        super().__init__(cfg, data_iter, **kw)

    def _build(self, cfg):
        models, engine, lidar_utils = build_layout_training(cfg, self.device)
        for m in models.values():
            train_running_statistics_(m)
        return models, engine, lidar_utils

    def _loss_kwargs(self) -> dict:
        return {"num_scenes": self.cfg.training.batch_size_train}

    def preview_images(self, state, seed, batch=None) -> dict:
        """None: the branch samples layouts, not range images (the JAX
        loop's base preview fails on them and logs ``preview_error``)."""
        return {}

    def rank_rows(self, prepared) -> dict:
        """This rank's scenes of the global batch, and its real nodes within
        the global node budget, padded to its share of it."""
        if self.real_nodes is None:
            raise ValueError("data-parallel layout training needs collated, unpadded scene-graph batches")
        P = self.parallel
        counts = P.gather_int(self.real_nodes)
        nodes = Rows(sum(counts[:P.rank]), counts[P.rank], self.max_nodes * P.world, self.max_nodes)
        return {"scene_rows": P.rows(self.cfg.training.batch_size_train // P.world), "node_rows": nodes}

    def prepare_batch(self, batch: dict) -> dict:
        self.real_nodes = None
        if "scenegraph" not in batch:
            dec = batch["decoder"] if "decoder" in batch else batch
            n = len(np.asarray(dec["objs"]))
            self.real_nodes = n
            e = len(np.asarray(dec.get("tripltes", dec.get("triples"))).reshape(-1, 3))
            if n > self.max_nodes or e > self.max_edges:
                self.max_nodes = max(self.max_nodes, _round8(n))
                self.max_edges = max(self.max_edges, _round8(e))
                self._log({"layout_budget_grow": {"max_nodes": self.max_nodes, "max_edges": self.max_edges}})
            batch = pad_layout_batch(batch, self.max_nodes, self.max_edges)
        return _to_device(batch, self.device)
