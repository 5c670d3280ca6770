# Copied from sherpa_vietnamese_asr_tpu/ops/hotword.py (host numpy; only the
# package path changes, and build_hotword_tables returns torch tensors).
# Hotword biasing: Aho-Corasick context graph + dense TPU transition tables.
#
# Semantics follow sherpa-onnx's ContextGraph as used by the reference app
# (reference core/hotword_context.py, itself a port of
# sherpa-onnx/csrc/context-graph.cc), re-implemented here from the algorithm:
#
#   * a trie over BPE token ids; each edge carries the full phrase score
#     (NOT divided by length); node_score = sum of edge scores from the root;
#     shared prefixes keep the max edge score;
#   * Aho-Corasick failure links; output links point to the nearest suffix
#     node that ends a phrase, and output_score accumulates through them;
#   * forward_one_step (non-strict mode): on a match advance and gain the edge
#     score; on mismatch follow failure links and gain (new.node_score -
#     old.node_score), which is <= 0; when a phrase completes, reset to the
#     root and credit the completed phrase's score;
#   * finalize: abandon a partial match, returning -node_score.
#
# Because forward_one_step is a pure function of (state, token), the whole
# automaton is precomputed into dense [S, V] tables (ops/beam_search.py
# gathers them on device inside the decode scan) — the TPU-native replacement
# for the reference's per-hypothesis Python object graph.

from __future__ import annotations

import unicodedata

import numpy as np


class _Node:
    __slots__ = ("token", "token_score", "node_score", "output_score",
                 "is_end", "children", "fail", "output", "index")

    def __init__(self, token=-1):
        self.token = token
        self.token_score = 0.0
        self.node_score = 0.0
        self.output_score = 0.0
        self.is_end = False
        self.children = {}
        self.fail = None
        self.output = None
        self.index = -1


class ContextGraph:
    """Aho-Corasick automaton over token ids with phrase-score boosting."""

    def __init__(self, token_sequences, scores):
        self.root = _Node()
        self.root.fail = self.root
        self.num_phrases = 0
        for seq, score in zip(token_sequences, scores):
            self._insert(seq, score)
        self._build_links()
        self.nodes = self._enumerate()

    def _insert(self, seq, score):
        if not seq:
            return
        node = self.root
        for pos, tok in enumerate(seq):
            last = pos == len(seq) - 1
            child = node.children.get(tok)
            if child is None:
                child = _Node(tok)
                child.token_score = score
                child.node_score = node.node_score + score
                if last:
                    child.is_end = True
                    child.output_score = child.node_score
                node.children[tok] = child
            else:
                # Shared prefix: keep the strongest phrase's edge score.
                child.token_score = max(child.token_score, score)
                child.node_score = node.node_score + child.token_score
                if last:
                    child.is_end = True
                    child.output_score = child.node_score
                elif child.is_end:
                    child.output_score = child.node_score
            node = child
        self.num_phrases += 1

    def _build_links(self):
        from collections import deque
        queue = deque()
        for child in self.root.children.values():
            child.fail = self.root
            queue.append(child)
        while queue:
            cur = queue.popleft()
            for tok, child in cur.children.items():
                fail = cur.fail
                while tok not in fail.children and fail is not self.root:
                    fail = fail.fail
                nxt = fail.children.get(tok)
                child.fail = nxt if (nxt is not None and nxt is not child) else self.root
                # Nearest phrase-ending suffix via failure chain.
                out = child.fail
                while out is not self.root and not out.is_end:
                    out = out.fail
                child.output = out if out.is_end else None
                if child.output is not None:
                    child.output_score += child.output.output_score
                queue.append(child)

    def _enumerate(self):
        from collections import deque
        nodes = [self.root]
        self.root.index = 0
        queue = deque([self.root])
        while queue:
            cur = queue.popleft()
            for child in cur.children.values():
                if child.index < 0:
                    child.index = len(nodes)
                    nodes.append(child)
                    queue.append(child)
        return nodes

    def forward_one_step(self, state: _Node, token: int):
        """Returns (score_delta, new_state); non-strict mode."""
        if token in state.children:
            node = state.children[token]
            score = node.token_score
        else:
            node = state.fail
            while token not in node.children and node is not self.root:
                node = node.fail
            node = node.children.get(token, self.root)
            score = node.node_score - state.node_score
        if node.output_score != 0.0:
            # A phrase completed (here or via a suffix link): credit it and
            # reset to the root.
            if node.is_end:
                matched = node.node_score
            elif node.output is not None:
                matched = node.output.node_score
            else:
                matched = node.node_score
            return score + matched - node.node_score, self.root
        return score, node

    def finalize(self, state: _Node) -> float:
        return -state.node_score


def build_dense_tables(graph: ContextGraph, vocab_size: int):
    """Materialize forward_one_step into dense numpy arrays.

    Returns (next_state [S, V] int32, delta [S, V] f32, node_score [S] f32).
    """
    s = len(graph.nodes)
    next_state = np.zeros((s, vocab_size), np.int32)
    delta = np.zeros((s, vocab_size), np.float32)
    node_score = np.zeros((s,), np.float32)
    # Tokens that appear anywhere in the automaton; all others behave like a
    # total mismatch from any state.
    interesting = set()
    for n in graph.nodes:
        interesting.update(n.children.keys())
    for i, node in enumerate(graph.nodes):
        node_score[i] = node.node_score
        # Default (token not in automaton): fall to root, delta = -node_score.
        next_state[i, :] = 0
        delta[i, :] = -node.node_score
        for tok in interesting:
            if tok < 0 or tok >= vocab_size:
                continue
            d, ns = graph.forward_one_step(node, tok)
            next_state[i, tok] = ns.index
            delta[i, tok] = d
    return next_state, delta, node_score


def parse_hotwords_file(path: str, default_score: float = 1.5):
    """Parse a hotwords file: one phrase per line, optional ' :score' suffix,
    '#' comments. Returns [(PHRASE_UPPER_NFC, score)]. Mirrors reference
    core/hotword_context.py:191-222."""
    import os
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            score = default_score
            if ":" in line:
                head, _, tail = line.rpartition(":")
                try:
                    score = float(tail.strip())
                    line = head.strip()
                except ValueError:
                    pass
            phrase = unicodedata.normalize("NFC", line.strip().upper())
            if phrase:
                out.append((phrase, score))
    return out


def build_hotword_tables(token_sequences, scores, vocab_size):
    """Convenience: phrases (as token-id sequences) -> (HotwordTables of CPU
    torch tensors: next_state int32, delta and node_score float32, graph)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import HotwordTables

    graph = ContextGraph(token_sequences, scores)
    nxt, delta, node_score = build_dense_tables(graph, vocab_size)
    return HotwordTables(
        next_state=torch.from_numpy(nxt),
        delta=torch.from_numpy(delta),
        node_score=torch.from_numpy(node_score),
    ), graph
