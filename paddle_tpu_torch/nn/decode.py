"""Seq2seq decoding: Decoder, BeamSearchDecoder, dynamic_decode and
gather_tree.

Counterpart of `paddle_tpu/nn/decode.py`: `Decoder` (:34), `gather_tree`
(:52), `BeamSearchDecoder` (:68-187) and `dynamic_decode` (:210-260, with
its 10000-step cap and warning). Each step's cell, projection, log-softmax
and the finished beams' mask run on the cell's device as
[batch * beam, ...] tensors; the scores then come to the host, where the
top-k and the bookkeeping (beam parents, tokens, finished flags, lengths)
run in numpy int64, as the reference keeps them. The top-k is a stable
sort of the negated scores: on ties the lower flat index comes first, as
`jax.lax.top_k` gives (`torch.topk` on CUDA promises no order). The
backtrace runs on the host at finalize.
"""
from __future__ import annotations

import warnings
from collections import namedtuple

import numpy as np
import torch

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree"]

_BeamState = namedtuple("_BeamState",
                        ["cell_states", "log_probs", "finished", "lengths"])
_BeamOutput = namedtuple("_BeamOutput", ["scores", "predicted_ids",
                                         "parent_ids"])


class Decoder:
    """Abstract decode contract (reference :34)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


def gather_tree(step_ids, parent_ids):
    """Backtrace beam parents: [T, batch, beam] ids and parents -> the full
    sequence of each surviving beam (host numpy)."""
    ids = np.asarray(step_ids)
    parents = np.asarray(parent_ids)
    T, B, W = ids.shape
    out = np.zeros_like(ids)
    for b in range(B):
        for w in range(W):
            parent = w
            for t in range(T - 1, -1, -1):
                out[t, b, w] = ids[t, b, parent]
                parent = int(parents[t, b, parent])
    return out


def _first(states) -> torch.Tensor:
    while isinstance(states, (tuple, list)):
        states = states[0]
    return torch.as_tensor(states)


class BeamSearchDecoder(Decoder):
    """Beam-search decoding over an RNN cell (reference :68).

    The cell's inputs and states ride as [batch * beam_size, ...]; any other
    per-batch tensor the cell reads (attention memory) must be tiled with
    `tile_beam_merge_with_batch` first."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch * beam_size, ...] (each row repeated)."""
        return torch.as_tensor(x).repeat_interleave(beam_size, 0)

    def _map_states(self, states, fn):
        if isinstance(states, (tuple, list)):
            return tuple(self._map_states(s, fn) for s in states)
        return fn(torch.as_tensor(states))

    def initialize(self, initial_cell_states):
        states = self._map_states(
            initial_cell_states,
            lambda s: self.tile_beam_merge_with_batch(s, self.beam_size))
        device = _first(states).device
        batch = _first(initial_cell_states).shape[0]
        W = self.beam_size
        # only beam 0 is live at first, or every beam would decode the same
        # argmax path
        log_probs = np.full((batch, W), -1e9, np.float32)
        log_probs[:, 0] = 0.0
        ids = torch.full((batch * W,), self.start_token, dtype=torch.int64,
                         device=device)
        inputs = self.embedding_fn(ids) if self.embedding_fn else ids
        state = _BeamState(cell_states=states,
                           log_probs=torch.from_numpy(log_probs).to(device),
                           finished=np.zeros((batch, W), bool),
                           lengths=np.zeros((batch, W), np.int64))
        return inputs, state, state.finished.copy()

    def step(self, time, inputs, states, **kwargs):
        W = self.beam_size
        cell_out, next_cell = self.cell(inputs, states.cell_states, **kwargs)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        V = logits.shape[-1]
        finished = states.finished                      # host [batch, W]
        lp = torch.log_softmax(logits, -1).reshape(-1, W, V)
        # finished beams emit only end_token, at probability 1: their score
        # is carried unchanged
        mask = torch.full((V,), -1e9, dtype=lp.dtype, device=lp.device)
        mask[self.end_token] = 0.0
        fin = torch.from_numpy(finished).to(lp.device)
        lp = torch.where(fin[:, :, None], mask, lp)
        scores = states.log_probs[:, :, None] + lp      # [batch, W, V]
        flat = scores.reshape(scores.shape[0], W * V).detach().float() \
            .cpu().numpy()
        idx_np = np.argsort(-flat, axis=1, kind="stable")[:, :W] \
            .astype(np.int64)
        top_scores = np.take_along_axis(flat, idx_np, axis=1)
        beam_np = idx_np // V
        tok_np = idx_np % V
        fin_gathered = np.take_along_axis(finished, beam_np, axis=1)
        len_gathered = np.take_along_axis(states.lengths, beam_np, axis=1)
        next_finished = fin_gathered | (tok_np == self.end_token)
        next_lengths = len_gathered + (~fin_gathered).astype(np.int64)

        batch = beam_np.shape[0]
        sel = torch.from_numpy(
            (np.arange(batch)[:, None] * W + beam_np).reshape(-1)).to(
            lp.device)
        next_cell = self._map_states(next_cell, lambda s: s[sel])
        next_ids = torch.from_numpy(tok_np.reshape(-1)).to(lp.device)
        next_inputs = self.embedding_fn(next_ids) if self.embedding_fn \
            else next_ids
        out = _BeamOutput(scores=top_scores, predicted_ids=tok_np,
                          parent_ids=beam_np)
        next_state = _BeamState(
            cell_states=next_cell,
            log_probs=torch.from_numpy(top_scores).to(lp.device),
            finished=next_finished, lengths=next_lengths)
        return out, next_state, next_inputs, next_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        step_ids = np.stack([o.predicted_ids for o in outputs])   # [T,B,W]
        parents = np.stack([o.parent_ids for o in outputs])
        return torch.from_numpy(gather_tree(step_ids, parents)), final_states

    @property
    def tracks_own_finished(self):
        return True


def _as_torch(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _default_stack(outputs):
    """Stack per-step outputs time-major when the decoder has no finalize:
    tensors stack to [T, ...]; namedtuple outputs stack per field."""
    first = outputs[0]
    if hasattr(first, "_fields"):
        return type(first)(*(torch.stack([_as_torch(getattr(o, f))
                                          for o in outputs])
                             for f in first._fields))
    return torch.stack([_as_torch(o) for o in outputs])


def _time_to_batch_major(x):
    if isinstance(x, torch.Tensor) or hasattr(x, "shape"):
        return _as_torch(x).movedim(0, 1)
    if hasattr(x, "_fields"):
        return type(x)(*(_time_to_batch_major(v) for v in x))
    return x


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step `decoder` until every sequence finishes or `max_step_num`.

    Returns (outputs, final_states), plus sequence_lengths when
    `return_length` (reference :210-260). Without `max_step_num` the loop
    stops at 10000 steps with a warning."""
    if impute_finished and not decoder.tracks_own_finished:
        raise NotImplementedError(
            "impute_finished=True needs finished-state rectification for "
            "this decoder; implement tracks_own_finished (as "
            "BeamSearchDecoder does) or decode without imputation")
    inputs, states, finished = decoder.initialize(inits)
    seq_lengths = np.zeros(np.shape(finished), np.int64)
    outputs = []
    step = 0
    warn_on_cap = max_step_num is None
    if warn_on_cap:
        max_step_num = 10000
    while not bool(np.all(finished)):
        out, states, inputs, finished = decoder.step(step, inputs, states,
                                                     **kwargs)
        if not decoder.tracks_own_finished:
            seq_lengths += ~np.asarray(finished)
        outputs.append(out)
        step += 1
        if step >= max_step_num:
            if warn_on_cap:
                warnings.warn(
                    "dynamic_decode hit the default 10000-step cap without "
                    "every beam emitting end_token; pass max_step_num to "
                    "raise or silence this")
            break
    lengths = getattr(states, "lengths", seq_lengths)
    try:
        final_outputs, final_states = decoder.finalize(outputs, states,
                                                       lengths)
    except NotImplementedError:
        final_outputs, final_states = _default_stack(outputs), states
    if not output_time_major:
        final_outputs = _time_to_batch_major(final_outputs)
    if return_length:
        return final_outputs, final_states, torch.from_numpy(
            np.asarray(lengths))
    return final_outputs, final_states
