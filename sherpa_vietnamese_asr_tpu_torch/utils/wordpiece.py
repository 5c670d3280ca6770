# Copied from sherpa_vietnamese_asr_tpu/utils/wordpiece.py (pure Python; only the package path changes).
# Minimal WordPiece tokenizer (BERT-style) — pure Python.
#
# Replaces the reference's transformers AutoTokenizer usage for ViBERT
# (reference core/gec_model.py:222-238) in environments without the
# checkpoint's tokenizer files. Greedy longest-match-first with "##"
# continuation pieces and [UNK] fallback; basic tokenization is NOT applied
# (the reference loads with do_basic_tokenize=False and feeds pre-split
# words).

from __future__ import annotations


class WordPieceTokenizer:
    def __init__(self, vocab, unk_token="[UNK]", pad_token="[PAD]",
                 max_chars_per_word=100):
        """vocab: {piece: id} or list of pieces (index = id)."""
        if isinstance(vocab, (list, tuple)):
            vocab = {p: i for i, p in enumerate(vocab)}
        self.vocab = dict(vocab)
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.unk_id = self.vocab.get(unk_token, 0)
        self.pad_id = self.vocab.get(pad_token, 0)
        self.max_chars = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path, **kw):
        with open(path, "r", encoding="utf-8") as f:
            pieces = [line.rstrip("\n") for line in f]
        return cls(pieces, **kw)

    def add_token(self, token):
        if token not in self.vocab:
            self.vocab[token] = len(self.vocab)
        return self.vocab[token]

    def tokenize_word(self, word):
        """One word -> list of piece ids (greedy longest match)."""
        if len(word) > self.max_chars:
            return [self.unk_id]
        if word in self.vocab:
            return [self.vocab[word]]
        pieces = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def encode_words(self, words):
        """Pre-split words -> (ids, word_ids) where word_ids[j] is the word
        index of subtoken j (mirrors transformers' word_ids())."""
        ids, word_ids = [], []
        for wi, w in enumerate(words):
            for pid in self.tokenize_word(w):
                ids.append(pid)
                word_ids.append(wi)
        return ids, word_ids
