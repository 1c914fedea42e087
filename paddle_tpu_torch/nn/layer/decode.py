"""Beam-search decoding — counterpart of ``paddle_tpu.nn.layer.decode``:
``Decoder``, ``BeamSearchDecoder``, ``dynamic_decode``, ``gather_tree``
and the batch-major one-step ``beam_search`` / ``beam_search_decode``.

Every tensor is batch-major with static shapes, as in the reference:
scores and ids [batch, beam], the cell's inputs and states merged as
[batch·beam, ...], finished beams masked, not removed. Beam 0 is the only
live beam at t = 0 (the others start at ``-1e9``), so the first top-k
picks distinct tokens; a finished beam proposes only ``end_token``, at no
cost. The state trees (nested tuples, lists, dicts and namedtuples such
as ``MultiHeadAttention.Cache``) are mapped by ``core.tree``; the beam
gather indexes each [batch, beam, ...] leaf with int64 indices on the
leaf's device, without a host sync. The top-k is a stable descending
sort, so ties keep the lower index first, as ``lax.top_k`` does.
``dynamic_decode`` reads one host flag a step (every beam finished?) to
stop early, as the reference does.
"""
from __future__ import annotations

import torch

from ...core.tree import leaves, tree_map

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree",
           "beam_search", "beam_search_decode"]

_KINF = 1e9


def _top_k(scores: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: ties keep the lower index."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def gather_tree(ids: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """The full history of each final beam: ``ids`` / ``parents``
    [T, batch, beam] → [T, batch, beam], column (b, k) the tokens of the
    k-th beam of the last step, followed back through ``parents``."""
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], ids.shape[2])
    out = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].long().gather(1, beam)
    return torch.stack(out, 0)


class Decoder:
    """The decoder interface: ``initialize`` → ``step``* → ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell(inputs, states) -> (outputs, new_states)``
    (an RNN cell, or any callable), ``embedding_fn`` mapping ids to the
    cell's inputs and ``output_fn`` its outputs to logits."""

    class OutputWrapper:
        def __init__(self, scores, predicted_ids, parent_ids):
            self.scores = scores
            self.predicted_ids = predicted_ids
            self.parent_ids = parent_ids

    class StateWrapper:
        def __init__(self, cell_states, log_probs, finished, lengths):
            self.cell_states = cell_states
            self.log_probs = log_probs
            self.finished = finished
            self.lengths = lengths

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
        """[batch, ...] → [batch·beam, ...], each row repeated."""
        return x.repeat_interleave(beam_size, dim=0)

    def _merge_batch_beams(self, x):
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    def _split_batch_beams(self, x):
        return x.reshape(x.shape[0] // self.beam_size, self.beam_size,
                         *x.shape[1:])

    def _expand_to_beam_size(self, x):
        return x[:, None].expand(x.shape[0], self.beam_size, *x.shape[1:])

    def initialize(self, initial_cell_states):
        cell_states = tree_map(self._expand_to_beam_size,
                               initial_cell_states)
        sample = leaves(cell_states)[0]
        b, k, dev = sample.shape[0], self.beam_size, sample.device
        log_probs = torch.full((b, k), -_KINF, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        state = self.StateWrapper(
            cell_states, log_probs, finished,
            torch.zeros((b, k), dtype=torch.int64, device=dev))
        init_ids = torch.full((b, k), self.start_token, dtype=torch.int64,
                              device=dev)
        init_inputs = (self.embedding_fn(init_ids)
                       if self.embedding_fn is not None else init_ids)
        return init_inputs, state, finished.clone()

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        b, k, v = logits.shape
        step_lp = torch.log_softmax(logits, dim=-1)
        noend = torch.full((v,), -_KINF, dtype=step_lp.dtype,
                           device=logits.device)
        noend[self.end_token] = 0.0
        prev_finished = beam_state.finished
        step_lp = torch.where(prev_finished[..., None], noend, step_lp)
        log_probs = step_lp + beam_state.log_probs[..., None]
        scores, top = _top_k(log_probs.reshape(b, k * v), k)
        beam_idx = torch.div(top, v, rounding_mode="floor")
        token_idx = top % v
        fin = prev_finished.gather(1, beam_idx)
        lengths = beam_state.lengths.gather(1, beam_idx) + (~fin).long()
        finished = fin | (token_idx == self.end_token)
        batch = torch.arange(b, device=logits.device)[:, None]
        next_cell_states = tree_map(lambda a: a[batch, beam_idx],
                                    next_cell_states)
        out = self.OutputWrapper(scores, token_idx, beam_idx)
        return out, self.StateWrapper(next_cell_states, scores, finished,
                                      lengths)

    def step(self, time, inputs, states, **kwargs):
        merged_inputs = tree_map(self._merge_batch_beams, inputs)
        merged_states = tree_map(self._merge_batch_beams,
                                 states.cell_states)
        cell_outputs, next_cell_states = self.cell(merged_inputs,
                                                   merged_states, **kwargs)
        cell_outputs = tree_map(self._split_batch_beams, cell_outputs)
        next_cell_states = tree_map(self._split_batch_beams,
                                    next_cell_states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        out, state = self._beam_search_step(time, cell_outputs,
                                            next_cell_states, states)
        ids = out.predicted_ids
        next_inputs = (self.embedding_fn(ids)
                       if self.embedding_fn is not None else ids)
        return out, state, next_inputs, state.finished

    def finalize(self, outputs, final_states, sequence_lengths):
        return gather_tree(outputs.predicted_ids,
                           outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every sequence has finished (one host read of
    the flags a step) or ``max_step_num`` steps (256 when None).
    ``(outputs, final_states[, lengths])``; for a ``BeamSearchDecoder``
    the outputs are the backtraced ids [batch, beam, T] ([T, batch, beam]
    if ``output_time_major``)."""
    inputs, states, finished = decoder.initialize(inits)
    dev = finished.device
    outputs = []
    for t in range(int(max_step_num if max_step_num is not None else 256)):
        out, states, inputs, step_finished = decoder.step(
            torch.tensor([t], dtype=torch.int64, device=dev), inputs,
            states, **kwargs)
        outputs.append(out)
        if getattr(decoder, "tracks_own_finished", False):
            finished = step_finished
        else:  # a step's flags cannot un-finish a sequence
            finished = finished | step_finished
        if bool(finished.all()):
            break
    if isinstance(decoder, BeamSearchDecoder):
        stacked = BeamSearchDecoder.OutputWrapper(
            *(torch.stack([getattr(o, f) for o in outputs], 0)
              for f in ("scores", "predicted_ids", "parent_ids")))
        lengths = states.lengths
        ids, final_states = decoder.finalize(stacked, states, lengths)
        if not output_time_major:
            ids = ids.permute(1, 2, 0)
        if return_length:
            return ids, final_states, lengths
        return ids, final_states
    outs = tree_map(
        lambda *xs: torch.stack(xs, 0 if output_time_major else 1),
        *outputs)
    if return_length:
        return outs, states, finished
    return outs, states


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One beam-search step over candidates ``scores`` [batch, beam, C]
    (accumulated, or probabilities if not ``is_accumulated``) with their
    token ``ids`` (None: the candidate's index): ``(selected_ids,
    selected_scores[, parent_idx])``, each [batch, beam]. A beam that
    ended (``pre_ids == end_id``) keeps its score and proposes only
    ``end_id``."""
    b, k, c = scores.shape
    if not is_accumulated:
        scores = torch.log(scores.clamp(min=1e-30)) + pre_scores[..., None]
    ended = pre_ids == end_id
    first = torch.arange(c, device=scores.device)[None, None, :] == 0
    frozen = torch.where(first, pre_scores[..., None],
                         torch.full_like(scores, -_KINF))
    scores = torch.where(ended[..., None], frozen, scores)
    top_scores, top = _top_k(scores.reshape(b, k * c), k)
    parent = torch.div(top, c, rounding_mode="floor")
    cand = top % c
    batch = torch.arange(b, device=scores.device)[:, None]
    sel = ids[batch, parent, cand].long() if ids is not None else cand
    sel = torch.where(ended[batch, parent], torch.full_like(sel, end_id),
                      sel)
    out = (sel, top_scores, parent)
    return out if return_parent_idx else out[:2]


def beam_search_decode(ids, scores, beam_size, end_id, name=None,
                       parent_ids=None):
    """``(sequences [batch, beam, T], final_scores [batch, beam])`` from
    the stacked per-step selections ``ids`` / ``scores`` [T, batch, beam]
    and their ``parent_ids`` (the identity when None)."""
    if parent_ids is None:
        t, b, k = ids.shape
        parent_ids = torch.arange(k, device=ids.device).expand(t, b, k)
    seqs = gather_tree(ids, parent_ids).permute(1, 2, 0)
    return seqs, scores[-1].float()
