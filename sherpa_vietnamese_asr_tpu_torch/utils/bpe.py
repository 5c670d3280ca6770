# Copied from sherpa_vietnamese_asr_tpu/utils/bpe.py (pure Python; only the package path changes).
# SentencePiece BPE: model-file parsing and encoding, pure Python.
#
# Replaces the `sentencepiece` C++ dependency the reference uses for hotword
# token encoding and bpe.vocab generation (reference core/hotword_context.py:
# 234-247, core/config.py:283-330). The .model file is a protobuf
# (ModelProto: repeated SentencePiece {piece: string = 1, score: float = 2,
# type: enum = 3}); we parse it with utils/protowire.py. Encoding uses the
# standard BPE merge rule: greedily merge the adjacent pair whose
# concatenation is the highest-scoring piece in the vocab (ties by position),
# starting from characters with U+2581 marking word starts — matching
# SentencePiece BPE inference (and the reference PWA's JS encoder,
# offline_pwa/static/js/pure-ort-asr-worker.js:140).

from __future__ import annotations

import struct
import unicodedata

from sherpa_vietnamese_asr_tpu_torch.utils import protowire as pw

_PIECE_FIELD = 1
_PIECE_STR = 1
_PIECE_SCORE = 2
_PIECE_TYPE = 3
# piece types: 1=NORMAL, 2=UNKNOWN, 3=CONTROL, 4=USER_DEFINED, 6=UNUSED, 5=BYTE
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2

WORD_BOUNDARY = "▁"


class BpeModel:
    def __init__(self, pieces):
        """pieces: list of (piece_str, score, type)."""
        self.pieces = pieces
        self.piece_to_id = {}
        self.scores = {}
        self.unk_id = 0
        for i, (piece, score, ptype) in enumerate(pieces):
            if piece not in self.piece_to_id:
                self.piece_to_id[piece] = i
            if ptype in (_TYPE_NORMAL, 4):
                self.scores[piece] = score
            if ptype == _TYPE_UNKNOWN:
                self.unk_id = i

    @classmethod
    def from_file(cls, path):
        with open(path, "rb") as f:
            buf = f.read()
        model = pw.parse_fields(buf)
        pieces = []
        for pb in model.get(_PIECE_FIELD, []):
            f = pw.parse_fields(pb)
            piece = f.get(_PIECE_STR, [b""])[0].decode("utf-8")
            score_raw = f.get(_PIECE_SCORE, [0])[0]
            score = struct.unpack("<f", struct.pack("<I", score_raw))[0] \
                if isinstance(score_raw, int) else 0.0
            ptype = f.get(_PIECE_TYPE, [_TYPE_NORMAL])[0]
            pieces.append((piece, score, ptype))
        if not pieces:
            raise ValueError(f"no pieces found in {path}")
        return cls(pieces)

    @classmethod
    def from_vocab(cls, vocab_lines):
        """From bpe.vocab-style 'piece<TAB>score' lines."""
        pieces = []
        for line in vocab_lines:
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            piece = parts[0]
            score = float(parts[1]) if len(parts) > 1 else 0.0
            ptype = _TYPE_UNKNOWN if piece == "<unk>" else (
                3 if piece in ("<s>", "</s>", "<blk>", "<sos/eos>")
                else _TYPE_NORMAL)
            pieces.append((piece, score, ptype))
        return cls(pieces)

    def id_to_piece(self, i):
        return self.pieces[i][0]

    def get_score(self, i):
        return self.pieces[i][1]

    def vocab_size(self):
        return len(self.pieces)

    def encode_pieces(self, text):
        """text -> list of piece strings (BPE merge inference)."""
        text = unicodedata.normalize("NFKC", text)
        out = []
        for word in text.split():
            symbols = [WORD_BOUNDARY + word[0]] + list(word[1:]) \
                if word else []
            if not symbols:
                continue
            while len(symbols) > 1:
                best_score, best_i = None, -1
                for i in range(len(symbols) - 1):
                    merged = symbols[i] + symbols[i + 1]
                    score = self.scores.get(merged)
                    if score is not None and (best_score is None
                                              or score > best_score):
                        best_score, best_i = score, i
                if best_i < 0:
                    break
                symbols[best_i: best_i + 2] = [symbols[best_i]
                                               + symbols[best_i + 1]]
            out.extend(symbols)
        return out

    def encode(self, text):
        """text -> list of token ids (unknown symbols -> unk_id per char)."""
        ids = []
        for piece in self.encode_pieces(text):
            pid = self.piece_to_id.get(piece)
            if pid is not None:
                ids.append(pid)
            else:
                for ch in piece:
                    ids.append(self.piece_to_id.get(ch, self.unk_id))
        return ids

    def dump_vocab(self, path):
        """Write bpe.vocab ('piece<TAB>score') like the reference's
        ensure_bpe_vocab (core/config.py:283-330)."""
        with open(path, "w", encoding="utf-8") as f:
            for piece, score, _ in self.pieces:
                f.write(f"{piece}\t{score}\n")
