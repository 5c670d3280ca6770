# GECToR-style punctuation/case restoration: the Seq2Labels decode loop.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/gec.py. The host logic is
# copied unchanged: load_gec_vocabulary, convert_using_case,
# get_target_sent_by_edits, chunk split and SequenceMatcher merge (56-token
# chunks, 16-token overlap), preprocess with its power-of-two buckets,
# _convert (the host oracle), get_token_action, postprocess_batch,
# handle_batch (up to 3 iterations with per-sentence convergence, pause
# hints on the first only) and __call__.
#
# The device part is rewritten in torch: vibert_decode is the JAX
# package's _vibert_decode_jit as one function on tensors. Per minibatch it
# takes one packed int32 upload ([mb, 2t+w]: ids | attention | offsets) and
# the [mb, w] pause hints, runs ViBERT, applies the confidence bias and the
# three pause nudges on the device (NaN hints leave a row untouched), and
# gives back only the [mb, w] max-prob and argmax and the [mb] error prob.
# _run_decode enqueues every minibatch before the first download;
# _run_model (the full logits, for the host _convert) stays as the oracle
# path. The weights arrive on the device with the module, uploaded once
# when it was built (the JAX package's __init__ uploads its host tree).
# With a mesh (parallel/sharding.py) each minibatch, its size rounded up to
# a multiple of the mesh, is split over the devices, one ViBERT replica
# each. The JAX package's AOT cache and warm_shapes (the serving warm-up)
# are not ported.

from __future__ import annotations

import os
import re

from difflib import SequenceMatcher

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.parallel import sharding


def vibert_decode(model, packed, hints, bias, nud_p, nud_c, nud_cneg, t, w,
                  noop_index, incorr_index):
    """ViBERT forward and the whole of _convert on the model's device.

    packed: [mb, 2t+w] int32 (ids | attention | offsets; token types are
    zeros, built here); hints: [mb, w] float32 seconds of gap after each
    token's word, NaN where none; bias, nud_*: [n_labels] float32. Returns
    (max prob [mb, w], label index [mb, w] int32, error prob [mb]) on the
    device. The nudges (gap >= 1.0 pushes $APPEND_. when $KEEP won, gap in
    [0.2, 1) pushes $APPEND_,, gap < 0.1 holds $APPEND_, back) are decided on
    the biased probabilities, before any nudge."""
    ids = packed[:, :t]
    att = packed[:, t:2 * t]
    offs = packed[:, 2 * t:2 * t + w]
    logits, detect = model(ids, att, torch.zeros_like(ids), offs)
    probs = torch.softmax(logits, dim=-1) + bias
    derr = torch.softmax(detect, dim=-1)[:, :, incorr_index].amax(dim=-1)
    cur_keep = torch.argmax(probs, dim=-1) == noop_index
    c1 = (hints >= 1.0) & cur_keep
    c2 = (hints >= 0.2) & (hints < 1.0) & cur_keep
    c3 = hints < 0.1
    probs = (probs + c1[..., None] * nud_p + c2[..., None] * nud_c
             + c3[..., None] * nud_cneg)
    return probs.amax(dim=-1), torch.argmax(probs, dim=-1).int(), derr


PAD = "@@PADDING@@"
UNK = "@@UNKNOWN@@"
START_TOKEN = "$START"

# reference vocabulary/labels.txt (15 labels, order matters)
DEFAULT_LABELS = [
    "$KEEP", "$TRANSFORM_CASE_CAPITAL", "$APPEND_,", "$APPEND_.",
    "$TRANSFORM_VERB_VB_VBN", "$TRANSFORM_CASE_UPPER", "$APPEND_:",
    "$APPEND_?", "$TRANSFORM_VERB_VB_VBC", "$TRANSFORM_CASE_LOWER",
    "$TRANSFORM_CASE_CAPITAL_1", "$TRANSFORM_CASE_UPPER_-1", "$MERGE_SPACE",
    UNK, PAD,
]
DEFAULT_D_TAGS = ["CORRECT", "INCORRECT", UNK, PAD]


def load_gec_vocabulary(directory):
    """Load label namespaces from an AllenNLP-style vocabulary directory
    (reference core/vocabulary.py:117-232 + vocabulary/): each *.txt is a
    namespace, one token per line, '@@NEWLINE@@' unescaped; namespaces
    matching non_padded_namespaces.txt patterns ('*tags'/'*labels') are
    0-indexed as-is, padded namespaces get '@@PADDING@@' prepended at 0.

    Returns {namespace: [tokens...]} — pass result['labels'] /
    result['d_tags'] to GecBert for checkpoint-specific label sets.
    """
    pad_file = os.path.join(directory, "non_padded_namespaces.txt")
    patterns = []
    if os.path.exists(pad_file):
        with open(pad_file, encoding="utf-8") as f:
            patterns = [ln.strip() for ln in f if ln.strip()]

    def non_padded(ns):
        return any((p[0] == "*" and ns.endswith(p[1:])) or p == ns
                   for p in patterns)

    out = {}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".txt") or fname == "non_padded_namespaces.txt":
            continue
        ns = fname[:-4]
        with open(os.path.join(directory, fname), encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines = lines[:-1]
        tokens = [ln.replace("@@NEWLINE@@", "\n") for ln in lines]
        out[ns] = tokens if non_padded(ns) else [PAD] + tokens
    return out


def convert_using_case(token, action):
    if not action.startswith("$TRANSFORM_CASE_"):
        return token
    if action.endswith("LOWER"):
        return token.lower()
    if action.endswith("UPPER_-1"):
        return token[:-1].upper() + token[-1]
    if action.endswith("UPPER"):
        return token.upper()
    if action.endswith("CAPITAL_1"):
        return token[0] + token[1:].capitalize()
    if action.endswith("CAPITAL"):
        return token.capitalize()
    return token


def get_target_sent_by_edits(source_tokens, edits):
    """Apply (start, end, label, prob) edits (gec_utils.py:31-67),
    restricted here to appends and case transforms."""
    target = source_tokens[:]
    shift = 0
    for start, end, label, _ in edits:
        pos = start + shift
        if start < 0:
            continue
        token = target[pos] if len(target) > pos else ""
        if label == "":
            del target[pos]
            shift -= 1
        elif start == end:
            word = label.replace("$APPEND_", "")
            if ((pos < len(target) and target[pos] == word)
                    or (pos > 0 and target[pos - 1] == word)):
                continue
            target[pos:pos] = [word]
            shift += 1
        elif label.startswith("$TRANSFORM_CASE_"):
            target[pos] = convert_using_case(token, label)
        elif label.startswith("$TRANSFORM_"):
            pass  # verb/split/agreement transforms are never emitted here
        elif start == end - 1:
            target[pos] = label.replace("$REPLACE_", "")
    return target


class GecBert:
    """Iterative Seq2Labels decoder over the port's ViBERT (a
    models/vibert.ViBert, either tier)."""

    def __init__(self, model, tokenizer, labels=None, d_tags=None,
                 max_len=80, min_len=3, iterations=3,
                 min_error_probability=0.0, confidence=0.0,
                 case_confidence=0.0, split_chunk=True, chunk_size=56,
                 overlap_size=16, min_words_cut=6,
                 punc_dict=(":", ".", ",", "?"), mini_batch_size=32,
                 mesh="auto"):
        # mesh "auto": every card of a multi-card host, else None (one device).
        self.mesh = sharding.resolve(mesh)
        mini_batch_size = sharding.round_up(mini_batch_size, self.mesh)
        self.model = model
        self.device = model.device
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.labels = list(labels or DEFAULT_LABELS)
        self.d_tags = list(d_tags or DEFAULT_D_TAGS)
        self.label_index = {t: i for i, t in enumerate(self.labels)}
        self.noop_index = self.label_index["$KEEP"]
        self.incorr_index = self.d_tags.index("INCORRECT")
        self.case_indices = [i for i, t in enumerate(self.labels)
                             if t.startswith("$TRANSFORM_CASE_")]
        self.append_period_index = self.label_index["$APPEND_."]
        self.append_comma_index = self.label_index["$APPEND_,"]
        self.max_len = max_len
        self.min_len = min_len
        self.iterations = iterations
        self.min_error_probability = min_error_probability
        self.confidence = confidence
        self.case_confidence = case_confidence
        assert chunk_size > 0 and chunk_size // 2 >= overlap_size
        self.split_chunk = split_chunk
        self.chunk_size = chunk_size
        self.overlap_size = overlap_size
        self.min_words_cut = min_words_cut
        self.stride = chunk_size - overlap_size
        self.punc_dict = set(punc_dict)
        self.punc_str = "[" + "".join(f"\\{x}" for x in punc_dict) + "]"
        self.mini_batch_size = mini_batch_size
        self.start_id = tokenizer.add_token(START_TOKEN)
        # Constant label-space vectors of vibert_decode: the confidence bias
        # and the three pause-nudge deltas, on the model's device.
        n_labels = len(self.labels)
        bias = np.zeros((n_labels,), np.float32)
        bias[self.noop_index] += np.float32(self.confidence)
        for i in self.case_indices:
            bias[i] += np.float32(self.case_confidence)
        nud_p = np.zeros((n_labels,), np.float32)
        nud_p[self.noop_index] = -0.2
        nud_p[self.append_period_index] = 0.2
        nud_c = np.zeros((n_labels,), np.float32)
        nud_c[self.append_comma_index] = 0.2
        nud_cneg = np.zeros((n_labels,), np.float32)
        nud_cneg[self.append_comma_index] = -0.3
        self._decode_vecs = tuple(torch.from_numpy(v).to(self.device)
                                  for v in (bias, nud_p, nud_c, nud_cneg))
        # Per device: (model, its copy of the vectors).
        self._replicas = list(zip(
            sharding.replicate(model, self.mesh),
            zip(*(sharding.replicate(v, self.mesh) for v in self._decode_vecs))))

    # -- chunking ----------------------------------------------------------
    def split_chunks(self, batch, pause_hints=None):
        result, indices = [], []
        hints_out = [] if pause_hints is not None else None
        for bi, tokens in enumerate(batch):
            start = len(result)
            n = len(tokens)
            hints = pause_hints[bi] if pause_hints is not None else None
            if n <= self.chunk_size:
                result.append(tokens)
                if hints is not None:
                    hints_out.append(hints[:n])
            elif n < (self.chunk_size * 2 - self.overlap_size):
                split = (n + self.overlap_size + 1) // 2
                result.append(tokens[:split])
                result.append(tokens[split - self.overlap_size:])
                if hints is not None:
                    hints_out.append(hints[:split])
                    hints_out.append(hints[split - self.overlap_size:])
            else:
                for i in range(0, n - self.overlap_size, self.stride):
                    result.append(tokens[i: i + self.chunk_size])
                    if hints is not None:
                        hints_out.append(hints[i: i + self.chunk_size])
            indices.append((start, len(result)))
        return result, indices, hints_out

    def apply_chunk_merging(self, tokens, next_tokens):
        if not tokens:
            return next_tokens
        src_idx, tgt_idx, src, tgt = [], [], [], []
        num_keep = self.overlap_size - self.min_words_cut
        i = 0
        while len(src_idx) < self.overlap_size and -i < len(tokens):
            i -= 1
            if tokens[i] not in self.punc_dict:
                src_idx.insert(0, i)
                src.insert(0, tokens[i].lower())
        i = 0
        while len(tgt_idx) < self.overlap_size and i < len(next_tokens):
            if next_tokens[i] not in self.punc_dict:
                tgt_idx.append(i)
                tgt.append(next_tokens[i].lower())
            i += 1

        tail_idx = head_idx = None
        for tag, i1, i2, j1, j2 in SequenceMatcher(None, src, tgt).get_opcodes():
            if tag == "equal":
                if i1 >= num_keep:
                    tail_idx, head_idx = src_idx[i1], tgt_idx[j1]
                    break
                if i2 > num_keep:
                    tail_idx = src_idx[num_keep]
                    head_idx = tgt_idx[j2 - i2 + num_keep]
                    break
            elif tag == "delete" and i1 == 0:
                num_keep += i2 // 2
        if tail_idx is None:
            raise ValueError("no overlap alignment found")
        return tokens[:tail_idx] + next_tokens[head_idx:]

    def merge_chunks(self, batch):
        result = []
        if len(batch) == 1 or self.overlap_size == 0:
            for sub in batch:
                result.extend(sub)
        else:
            for sub in batch:
                try:
                    result = self.apply_chunk_merging(result, sub)
                except Exception:
                    result = result + sub
        return " ".join(result)

    # -- model io ----------------------------------------------------------
    def preprocess(self, token_batch):
        """Tokenize + offsets -> padded arrays (gec_model.py:445-481)."""
        seq_lens = [len(s) for s in token_batch if s]
        if not seq_lens:
            return None
        max_words = min(max(seq_lens), self.max_len)
        ids_rows, offset_rows = [], []
        for seq in token_batch:
            words = [START_TOKEN] + seq[:max_words]
            ids, word_ids = [], []
            for wi, w in enumerate(words):
                if w == START_TOKEN:
                    sub = [self.start_id]
                else:
                    sub = self.tokenizer.tokenize_word(w)
                ids.extend(sub)
                word_ids.extend([wi] * len(sub))
            # BERT position-embedding ceiling; also bounds the shape-bucket
            # set to powers of two <= max_position.
            ids = ids[:self.cfg.max_position]
            word_ids = word_ids[:self.cfg.max_position]
            offsets = [0] + [j for j in range(1, len(word_ids))
                             if word_ids[j] != word_ids[j - 1]]
            ids_rows.append(ids)
            offset_rows.append(offsets)
        # Bucket sequence dims to powers of two (min 64), as the JAX package
        # does for its compiled shapes: with 56-word chunks the wordpiece dim
        # lands in the 128 bucket and the offsets dim in 64 for virtually
        # all real text.
        def _bucket(n):
            b = 64
            while b < n:
                b *= 2
            return b

        t_max = _bucket(max(len(r) for r in ids_rows))
        w_max = _bucket(max(len(r) for r in offset_rows))
        b = len(ids_rows)
        input_ids = np.zeros((b, t_max), np.int32)
        attention = np.zeros((b, t_max), np.int32)
        offsets = np.zeros((b, w_max), np.int32)
        for i, (ids, offs) in enumerate(zip(ids_rows, offset_rows)):
            input_ids[i, :len(ids)] = ids
            attention[i, :len(ids)] = 1
            offsets[i, :len(offs)] = offs
        return {
            "input_ids": input_ids,
            "attention_mask": attention,
            "token_type_ids": np.zeros_like(input_ids),
            "input_offsets": offsets,
        }

    def _upload(self, a):
        """A minibatch's pieces, one a device (one piece without a mesh)."""
        return sharding.shard_batch(a, self.mesh, self.device)[0]

    def _run_decode(self, inputs, hints_rows=None):
        """On-device forward + convert (vibert_decode): one packed int32
        upload and [mb, W]-sized downloads per minibatch. Returns (max_probs
        [B, W], label_idxs [B, W], error_probs [B]) as nested lists, the
        output contract of _convert(_run_model(...))."""
        ids = inputs["input_ids"]
        att = inputs["attention_mask"]
        offs = inputs["input_offsets"]
        b, t = ids.shape
        w = offs.shape[1]
        hints_arr = np.full((b, w), np.nan, np.float32)
        if hints_rows is not None:
            for i, hints in enumerate(hints_rows):
                if hints is None:
                    continue
                hv = np.asarray(list(hints), np.float32)[: w - 1]
                # word wi's gap applies at token index wi+1 ($START at 0)
                hints_arr[i, 1: 1 + len(hv)] = hv
        mb = self.mini_batch_size
        # Enqueue every minibatch first, download after: on the card the
        # host's next upload rides under the previous minibatch's forward.
        launched = []
        with torch.no_grad():
            for i in range(0, b, mb):
                sl = slice(i, min(i + mb, b))
                k = sl.stop - sl.start
                packed = np.zeros((mb, 2 * t + w), np.int32)
                packed[:k, :t] = ids[sl]
                packed[:k, t: 2 * t] = att[sl]
                packed[:k, 2 * t:] = offs[sl]
                hsl = np.full((mb, w), np.nan, np.float32)
                hsl[:k] = hints_arr[sl]
                outs = []
                for (model, vecs), p, h in zip(self._replicas, self._upload(packed),
                                               self._upload(hsl)):
                    with sharding.device_scope(p.device):
                        outs.append(vibert_decode(
                            model, p, h, *vecs, t=t, w=w, noop_index=self.noop_index,
                            incorr_index=self.incorr_index))
                launched.append((k, outs))
            mp_parts, idx_parts, err_parts = [], [], []
            for k, outs in launched:
                mp, ix, er = (sharding.gather(parts, k) for parts in zip(*outs))
                mp_parts.append(mp)
                idx_parts.append(ix)
                err_parts.append(er)
        return (np.concatenate(mp_parts, axis=0).tolist(),
                np.concatenate(idx_parts, axis=0).tolist(),
                np.concatenate(err_parts, axis=0).tolist())

    def _run_model(self, inputs):
        """The full logits and detect logits [B, W, *] on the host, one
        minibatch of mini_batch_size rows at a time (the oracle path)."""
        b = inputs["input_ids"].shape[0]
        mb = self.mini_batch_size
        logits_parts, detect_parts = [], []
        with torch.no_grad():
            for i in range(0, b, mb):
                sl = slice(i, min(i + mb, b))

                def pad(a):
                    out = np.zeros((mb,) + a.shape[1:], a.dtype)
                    out[: sl.stop - sl.start] = a[sl]
                    return self._upload(out)
                outs = []
                for (model, _), *args in zip(self._replicas, *(pad(inputs[k]) for k in (
                        "input_ids", "attention_mask", "token_type_ids", "input_offsets"))):
                    with sharding.device_scope(args[0].device):
                        outs.append(model(*args))
                lg, dt = (sharding.gather(parts, sl.stop - sl.start) for parts in zip(*outs))
                logits_parts.append(lg)
                detect_parts.append(dt)
        return (np.concatenate(logits_parts, axis=0),
                np.concatenate(detect_parts, axis=0))

    # -- conversion / edits --------------------------------------------------
    def _softmax(self, x):
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def _convert(self, logits, detect, pause_hints_batch=None):
        probs = self._softmax(logits)
        d = self._softmax(detect)
        error_probs = d[:, :, self.incorr_index].max(axis=-1)
        if self.confidence != 0.0:
            probs[:, :, self.noop_index] += self.confidence
        if self.case_confidence != 0.0:
            for idx in self.case_indices:
                probs[:, :, idx] += self.case_confidence
        if pause_hints_batch is not None:
            for bi, hints in enumerate(pause_hints_batch):
                if hints is None:
                    continue
                for wi, gap in enumerate(hints):
                    ti = wi + 1  # START_TOKEN at position 0
                    if ti >= probs.shape[1]:
                        break
                    cur = int(probs[bi, ti].argmax())
                    if gap >= 1.0:
                        if cur == self.noop_index:
                            probs[bi, ti, self.noop_index] -= 0.2
                            probs[bi, ti, self.append_period_index] += 0.2
                    elif gap >= 0.2:
                        if cur == self.noop_index:
                            probs[bi, ti, self.append_comma_index] += 0.2
                    elif gap < 0.1:
                        probs[bi, ti, self.append_comma_index] -= 0.3
        return (probs.max(axis=-1).tolist(), probs.argmax(axis=-1).tolist(),
                error_probs.tolist())

    def get_token_action(self, index, prob, sugg):
        """Punct appends and case transforms only (gec_model.py:414-443)."""
        if prob < self.min_error_probability or sugg in (UNK, PAD, "$KEEP"):
            return None
        if sugg == "$DELETE" or sugg.startswith("$REPLACE_"):
            return None
        if sugg.startswith("$APPEND_"):
            if sugg.replace("$APPEND_", "") not in self.punc_dict:
                return None
            start = end = index + 1
        elif sugg.startswith("$TRANSFORM_CASE_"):
            start, end = index, index + 1
        else:
            return None
        return start - 1, end - 1, sugg, prob

    def postprocess_batch(self, batch, probabilities, idxs, error_probs):
        results = []
        for tokens, probs, idx, err in zip(batch, probabilities, idxs,
                                           error_probs):
            length = min(len(tokens), self.max_len)
            if max(idx) == 0 or err < self.min_error_probability:
                results.append(tokens)
                continue
            edits = []
            for i in range(length + 1):
                if idx[i] == self.noop_index:
                    continue
                sugg = self.labels[idx[i]]
                action = self.get_token_action(i, probs[i], sugg)
                if action:
                    edits.append(action)
            results.append(get_target_sent_by_edits(tokens, edits))
        return results

    # -- main loop -----------------------------------------------------------
    def handle_batch(self, full_batch, merge_punc=True, pause_hints=None,
                     progress_callback=None):
        if self.split_chunk:
            full_batch, indices, hints_chunks = self.split_chunks(
                full_batch, pause_hints=pause_hints)
        else:
            indices, hints_chunks = None, pause_hints
        final_batch = full_batch[:]
        prev_preds = {i: [final_batch[i]] for i in range(len(final_batch))}
        short = {i for i in range(len(full_batch))
                 if len(full_batch[i]) < self.min_len}
        pred_ids = [i for i in range(len(full_batch)) if i not in short]

        for n_iter in range(self.iterations):
            orig = [final_batch[i] for i in pred_ids]
            hints = ([hints_chunks[i] for i in pred_ids]
                     if n_iter == 0 and hints_chunks is not None else None)
            inputs = self.preprocess(orig)
            if inputs is None:
                break
            probs, idxs, errs = self._run_decode(inputs, hints_rows=hints)
            pred_batch = self.postprocess_batch(orig, probs, idxs, errs)
            new_pred_ids = []
            for i, oid in enumerate(pred_ids):
                if final_batch[oid] != pred_batch[i]:
                    if pred_batch[i] not in prev_preds[oid]:
                        new_pred_ids.append(oid)
                        prev_preds[oid].append(pred_batch[i])
                    final_batch[oid] = pred_batch[i]
            pred_ids = new_pred_ids
            if progress_callback:
                progress_callback(n_iter + 1, self.iterations)
            if not pred_ids:
                break

        if self.split_chunk:
            final_batch = [self.merge_chunks(final_batch[s:e])
                           for s, e in indices]
        else:
            final_batch = [" ".join(x) for x in final_batch]
        if merge_punc:
            final_batch = [re.sub(r"\s+(%s)" % self.punc_str, r"\1", x)
                           for x in final_batch]
        return final_batch

    def __call__(self, text, pause_hints=None, progress_callback=None):
        if isinstance(text, str):
            batch = [text.split()]
            hints = [pause_hints] if pause_hints is not None else None
        else:
            batch = [x.split() if isinstance(x, str) else list(x)
                     for x in text]
            hints = pause_hints
        return self.handle_batch(batch, pause_hints=hints,
                                 progress_callback=progress_callback)
