"""Batched sliding-window inference: wav windows -> stitched talk probs.

Counterpart of ``wav2vecsegmenter_tpu/infer/pipeline.py``.  The engine
knows its task's loss tag: the bce head's probability is the sigmoid of
its logit; the multi-class heads' (``ce``, ``ssl``, ``ctc``) is the
softmax's p(``<B>``), token 0; ``SHASWithSSL``'s CTC logits are not
downloaded.  An offline batch uploads its raw int16 samples, is
normalized on the device (reference lib/datautils.py:120-125: mean and
ddof=1 std over the batch's longest window, rows with zero std and
excluded rows zeroed), runs the model, and downloads only the [B, T]
probabilities (and, when the caller asks, the [B, T, V] frame logits for
``dac_logits``): a ``non_blocking`` copy into pinned host memory followed
by a CUDA event, so the host goes on dispatching while the copy is in
flight.
An online batch (``infer.online``) arrives normalized on the host by
``collate`` and uploads as float32.

With a ``loss_fn`` (the trainer's evaluation), a batch that carries
targets also computes its masked loss on the device (``batch_loss``), and
the handle downloads it beside the probabilities.

The stitch helpers (``stitch_row``, ``nan_fill``) mirror the JAX module's
for probabilities, logits and targets.  Their semantics replicate
reference lib/evaluate.py:9-127, including the NaN fill of a 2-D logits
row with one scalar mean over its whole [5, V] neighbourhood.

``runtime.precision`` (``resolve_precision``) picks an arm of the JAX
package's precision ladder, between the bf16 path and float32;
``runtime.quantize=int8`` quantizes the encoder's products into the engine
(``ops.quant``), leaving the model's module as it was.  A model without
the ladder's knobs (``SHASWithSSL``, whose JAX ``apply`` takes none, and
``AutoRegSegmenter``, whose JAX decode ignores them: ROADMAP C17)
refuses the arms between bf16 and float32.

On a mesh (``mesh``, ``parallel.mesh``) each data rank runs its rows of
every batch, on a model split over the mesh's model axis where it has one,
and the probabilities, logits and row losses come back gathered, in batch
order, on every rank; a batch's rows are normalized over the whole batch's
``norm_length``.  A rank that read only its rows (``data.windows.
LocalBatch``) also gathers their starts, ends, ``included`` flags and
targets, which :func:`collect_talk` stitches in place of the batch's.
int8 does not compose with tensor parallelism, as in the JAX engine.

A model with a ``greedy_decode`` (the autoregressive segmenter,
``task=arseg``) decodes each batch one token a frame instead: its
probabilities are p(in-segment) = softmax([l_B, l_NB])[1], and its
[B, T, 4] frame logits are the decode's (JAX ``infer/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch

from ..data.collate import Batch
from ..data.windows import LocalBatch
from ..ops.quant import quantize_layers
from ..parallel.mesh import all_gather, local_rows

# runtime.precision: CUMULATIVE arms between bf16 and float32, trading
# throughput for near-threshold probability fidelity (the JAX package's
# ladder, wav2vecsegmenter_tpu/infer/pipeline.py):
#   bf16      everything in the compute dtype (the default)
#   f32head   + the SFC head in float32
#   f32res    + the encoder's residual stream and LayerNorms in float32
#   f32lastK  + the last K encoder layers entirely in float32 (f32last4)
#   f32       everything in float32 (the oracle)
PRECISION_ARMS = ("bf16", "f32head", "f32res", "f32last4", "f32")
# the batch fields that stitch_row reads
STITCH_ROWS = ("starts", "ends", "included", "target")


def resolve_precision(precision: str | None, compute_dtype):
    """(compute dtype, model kwargs) for a runtime.precision value."""
    if not precision or precision == "bf16":
        return compute_dtype, {}
    if precision == "f32":
        return torch.float32, {}
    kwargs: dict = {"head_dtype": torch.float32}
    if precision == "f32head":
        return compute_dtype, kwargs
    kwargs["residual_dtype"] = torch.float32
    if precision == "f32res":
        return compute_dtype, kwargs
    if precision.startswith("f32last"):
        kwargs["f32_last_k"] = int(precision[len("f32last"):])
        return compute_dtype, kwargs
    raise ValueError(
        f"unknown runtime.precision '{precision}' "
        f"(expected one of {PRECISION_ARMS}, f32last<k> for any k)")


def normalize_int16(audio: torch.Tensor, norm_length: int,
                    included: torch.Tensor) -> torch.Tensor:
    """int16 [B, L] -> float32 normalized over [0, norm_length), ddof=1."""
    x = audio.float() / 32768.0
    in_norm = torch.arange(x.shape[1], device=x.device) < norm_length
    count = float(norm_length)
    mean = torch.where(in_norm, x, 0.0).sum(1, keepdim=True) / count
    dev = torch.where(in_norm, x - mean, 0.0)
    std = torch.sqrt((dev * dev).sum(1, keepdim=True) / (count - 1))
    xn = torch.where(std > 0, dev / std.clamp_min(1e-12), 0.0)
    return torch.where(included[:, None], xn, 0.0)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A batch field on ``device``, copied without blocking the host.  The
    reader's pinned audio goes up from the pinned tensor under its numpy
    view, so that the pinned-memory cache holds the block until the copy
    is done."""
    base = a.base if isinstance(a, np.ndarray) else None
    if not (isinstance(base, torch.Tensor) and tuple(base.shape) == a.shape
            and base.data_ptr() == a.ctypes.data):
        base = torch.from_numpy(np.asarray(a))
    return base.to(device, non_blocking=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


class ProbsHandle:
    """A batch's probabilities (and its loss and frame logits, if computed,
    and a rank's gathered ``rows``: :func:`gather_rows`) on their way to
    the host."""

    def __init__(self, probs: torch.Tensor, loss: torch.Tensor | None = None,
                 logits: torch.Tensor | None = None,
                 rows: GatheredRows | None = None):
        self._host = _to_host(probs)
        self._loss = None if loss is None else _to_host(loss)
        self._logits = None if logits is None else _to_host(logits)
        self._rows = None if rows is None else dataclasses.replace(
            rows, packed=_to_host(rows.packed))
        self._event = None
        if probs.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

    def logits(self) -> np.ndarray | None:
        if self._logits is None:
            return None
        if self._event is not None:
            self._event.synchronize()
        return self._logits.numpy()

    def loss(self) -> float | None:
        if self._loss is None:
            return None
        if self._event is not None:
            self._event.synchronize()
        return float(self._loss)

    def rows(self) -> types.SimpleNamespace:
        """The gathered row fields, as numpy arrays."""
        if self._event is not None:
            self._event.synchronize()
        return self._rows.numpy()


def row_losses(loss_fn, logits: torch.Tensor, target: torch.Tensor,
               out_mask: torch.Tensor) -> torch.Tensor:
    """Each row's masked eval loss: the per-point loss zeroed off
    ``out_mask``, summed over the row."""
    t = min(logits.shape[1], target.shape[1])
    lpp = torch.where(out_mask[:, :t], loss_fn(logits[:, :t].float(),
                                               target[:, :t]), 0.0)
    return lpp.sum(dim=1)


def batch_loss(loss_fn, logits: torch.Tensor, target: torch.Tensor,
               out_mask: torch.Tensor, n_real: int) -> torch.Tensor:
    """Masked eval loss of one batch (reference lib/evaluate.py:74-81):
    :func:`row_losses` meaned over the batch's real rows only."""
    rows = row_losses(loss_fn, logits, target, out_mask)
    return rows[:n_real or len(rows)].mean()


def local_batch(batch, mesh):
    """This data rank's rows of a batch (every per-row field sliced; the
    batch-wide ones, ``norm_length`` and ``n_real``, kept); a batch the
    rank read as its rows (``LocalBatch``) as it is."""
    if mesh is None or mesh.n_data == 1:
        return batch
    b = len(batch.included)
    if getattr(batch, "global_slots", 0):
        if batch.global_slots != b * mesh.n_data:
            raise ValueError(f"{b} rows of a batch of {batch.global_slots} "
                             f"on {mesh.n_data} data ranks")
        return batch
    return dataclasses.replace(batch, **{
        f.name: local_rows(v, mesh) for f in dataclasses.fields(batch)
        if isinstance(v := getattr(batch, f.name), np.ndarray)
        and v.ndim and v.shape[0] == b})


@dataclasses.dataclass
class GatheredRows:
    """Row fields of every data rank's rows in batch order, as one byte
    tensor (:func:`gather_rows`): ``packed`` [rows, bytes a row], and each
    field's (name, (dtype, row shape)), or (name, None) for a field the
    batch lacks."""
    packed: torch.Tensor
    layout: tuple

    def numpy(self) -> types.SimpleNamespace:
        """The fields, as numpy arrays."""
        packed = self.packed.cpu().numpy()
        out, at = {}, 0
        for name, spec in self.layout:
            if spec is None:
                out[name] = None
                continue
            dtype, shape = spec
            width = dtype.itemsize * math.prod(shape)
            out[name] = np.ascontiguousarray(packed[:, at:at + width]).view(
                dtype).reshape(len(packed), *shape)
            at += width
        return types.SimpleNamespace(**out)


def gather_rows(batch, names, mesh, device) -> GatheredRows:
    """The fields ``names`` of a rank's rows (``LocalBatch``), gathered
    over the mesh's data ranks in batch order by one ``all_gather`` of the
    rows' bytes, on ``device``."""
    n = len(batch.included)
    layout, cols = [], []
    for name in names:
        v = getattr(batch, name)
        if v is None:
            layout.append((name, None))
            continue
        v = np.ascontiguousarray(v)
        layout.append((name, (v.dtype, v.shape[1:])))
        cols.append(v.reshape(n, -1).view(np.uint8))
    packed = upload(np.concatenate(cols, axis=1), device)
    return GatheredRows(all_gather(packed, mesh.data_group), tuple(layout))


class WindowInference:
    """Runs window batches through a SHAS-family model on one device, at
    the arm of the precision ladder that ``precision`` names;
    ``quantize="int8"`` runs the encoder's products int8 (the weights
    quantized once, here).  ``loss_tag`` is the task's: ``bce`` (sigmoid)
    or a multi-class tag (softmax p(<B>))."""

    def __init__(self, model, device, compute_dtype=torch.float32,
                 precision: str | None = None, quantize: str | None = None,
                 loss_tag: str = "bce", mesh=None):
        self.model = model
        self.device = torch.device(device)
        self.loss_tag = loss_tag
        self.mesh = mesh
        # the model's keyword arguments: the precision arm's, and the int8
        # layers under quantize
        self.compute_dtype, self.forward_kwargs = resolve_precision(
            precision, compute_dtype)
        if self.forward_kwargs and not getattr(model, "precision_ladder",
                                               True):
            raise ValueError(
                f"runtime.precision={precision} does not run on "
                f"{type(model).__name__}: its forward takes no precision "
                "knobs (as the JAX package's apply); use bf16 or f32")
        self.quantized = None
        if quantize:
            if quantize != "int8":
                raise ValueError(f"unknown quantize mode '{quantize}' "
                                 "(supported: int8)")
            if mesh is not None and mesh.n_model > 1:
                raise ValueError(
                    "runtime.quantize=int8 does not compose with tensor "
                    "parallelism (per-channel scales are not partitioned)")
            self.quantized = quantize_layers(model.backbone.encoder)
            self.forward_kwargs = {**self.forward_kwargs,
                                   "quantized": self.quantized}
        self.loss_fn = None  # the trainer sets its epoch's loss for eval

    def run_batch(self, batch: Batch, need_logits: bool = False
                  ) -> ProbsHandle:
        """Launch one batch; the handle downloads its probabilities, and its
        frame logits (zero off ``out_mask``) under ``need_logits``.  On a
        mesh this rank runs its rows and the handle holds the batch's (under
        ``no_grad``: an FSDP model's gathered parameters must not become
        inference tensors)."""
        mode = torch.inference_mode if self.mesh is None else torch.no_grad
        with mode():
            return self._run_batch(batch, need_logits)

    def _run_batch(self, batch: Batch, need_logits: bool) -> ProbsHandle:
        probs, loss, logits = self._run_rows(local_batch(batch, self.mesh),
                                             need_logits)
        mesh = self.mesh
        rows = None
        if mesh is not None and mesh.n_data > 1:
            def gather(t):
                return None if t is None else all_gather(
                    t, mesh.data_group)
            probs, loss, logits = gather(probs), gather(loss), gather(logits)
            if isinstance(batch, LocalBatch):
                rows = gather_rows(batch, STITCH_ROWS, mesh, self.device)
        if loss is not None:
            loss = loss[:batch.n_real or len(loss)].mean()
        return ProbsHandle(probs, loss, logits, rows)

    def _run_rows(self, batch: Batch, need_logits: bool):
        """(probabilities, row losses or None, logits or None) of a batch's
        rows on the device."""
        def up(a):
            return upload(a, self.device)

        out_mask = up(batch.out_mask)
        audio = up(batch.audio)
        if batch.device_normalize:  # else collate normalized on the host
            audio = normalize_int16(audio, batch.norm_length,
                                    up(batch.included))
        if hasattr(self.model, "greedy_decode"):
            probs, logits, _ = self.model.greedy_decode(
                audio, up(batch.in_lengths), out_mask.shape[1],
                self.compute_dtype, **self.forward_kwargs)
            logits_out = None
            if need_logits:
                logits_out = torch.where(out_mask[..., None], logits, 0.0)
            return torch.where(out_mask, probs, 0.0), None, logits_out
        logits = self.model(audio, up(batch.in_lengths), out_mask,
                            self.compute_dtype, **self.forward_kwargs)
        if isinstance(logits, tuple):  # SHASWithSSL: (ctc, frame)
            logits = logits[1]
        if self.loss_tag == "bce":
            probs = torch.sigmoid(logits.float())
        else:  # p(<B>), the boundary token 0
            probs = torch.softmax(logits.float(), dim=-1)[..., 0]
        probs = torch.where(out_mask, probs, 0.0)
        loss = None
        if self.loss_fn is not None and batch.target is not None:
            loss = row_losses(self.loss_fn, logits, up(batch.target),
                              out_mask)
        logits_out = None
        if need_logits:
            mask = out_mask if logits.dim() == 2 else out_mask[..., None]
            logits_out = torch.where(mask, logits, 0.0)
        return probs, loss, logits_out


def nan_fill(arr: np.ndarray, duration: int) -> None:
    """Fill frames that never got a prediction with the mean of their
    neighbourhood (reference lib/evaluate.py:118-125); in place.  A 2-D
    logits row gets one scalar: the reference's ``np.nanmean`` has no
    axis, so it means over the whole [5, V] neighbourhood."""
    for j in np.where(np.isnan(arr if arr.ndim == 1 else arr[:, 0]))[0]:
        lo, hi = max(0, j - 2), min(duration, j + 3)
        arr[j] = np.nanmean(arr[lo:hi])


def stitch_row(talk_probs, batch, i, probs, duration_outframes: int,
               talk_targets=None, talk_logits=None, logits=None) -> None:
    """Scatter one window row into the talk array (its targets into
    ``talk_targets``, its logits into ``talk_logits``); an excluded
    (silent) row writes zero probabilities and logits and no targets.  A
    talk whose length lands on a .5 output frame puts the last window's end
    one past the talk array; it is clamped."""
    start, end = int(batch.starts[i]), int(batch.ends[i])
    end = min(end, duration_outframes)
    if end <= start:
        return
    if not batch.included[i]:
        talk_probs[start:end] = 0
        if talk_logits is not None:
            talk_logits[start:end] = 0
        return
    talk_probs[start:end] = probs[i, :end - start]
    if talk_logits is not None:
        talk_logits[start:end] = logits[i, :end - start]
    if talk_targets is not None and batch.target is not None:
        talk_targets[start:end] = batch.target[i, :end - start]


def dispatch_talk(engine: WindowInference, batches,
                  need_logits: bool = False) -> list:
    """Upload and launch every window batch of one talk without waiting;
    returns (handle, batch) pairs for :func:`collect_talk`."""
    return [(engine.run_batch(batch, need_logits), batch)
            for batch in batches]


def talk_logits_array(vocab_size: int, duration_outframes: int):
    """A NaN-filled stitch target for one talk's frame logits: [T] for the
    bce head, [T, V] for a multi-class head."""
    shape = (duration_outframes,) if vocab_size == 1 else \
        (duration_outframes, vocab_size)
    return np.full(shape, np.nan)


def collect_talk(pending: list, duration_outframes: int,
                 talk_targets: np.ndarray | None = None,
                 losses: list | None = None,
                 talk_logits: np.ndarray | None = None) -> np.ndarray:
    """Download and stitch the handles of :func:`dispatch_talk` into the
    talk's frame probabilities, gaps filled; the targets go into
    ``talk_targets``, the batches' losses onto ``losses`` and their logits
    (dispatched with ``need_logits``) into ``talk_logits``
    (:func:`talk_logits_array`, gaps filled too), when given."""
    talk_probs = np.full(duration_outframes, np.nan)
    for handle, batch in pending:
        if isinstance(batch, LocalBatch):  # a rank's rows: the whole batch's
            batch = handle.rows()
        probs = handle.numpy()
        logits = None if talk_logits is None else handle.logits()
        loss = handle.loss()
        if losses is not None and loss is not None:
            losses.append(loss)
        for i in range(len(probs)):
            stitch_row(talk_probs, batch, i, probs, duration_outframes,
                       talk_targets, talk_logits, logits)
    nan_fill(talk_probs, duration_outframes)
    if talk_logits is not None:
        nan_fill(talk_logits, duration_outframes)
    return talk_probs
