"""TokenTextEncoder — fairseq-style phone/text token encoder (legacy TTS
path; reference ``utils/text_encoder.py``).

A copy of ``diffsvc_tpu/utils/text_encoder.py``; ``tests/test_torch_standalone.py``
holds it against the original.

Reserved ids: 0 = <pad>, 1..NUM_RESERVED-1 include <EOS>; the SVC pipeline
never encodes text, but the encoder is kept so reference TTS-style datasets
and ``phone_set.json`` files load.
"""

from __future__ import annotations

from typing import List, Optional

PAD = "<pad>"
EOS = "<EOS>"
UNK = "<UNK>"
SEG = "|"
RESERVED_TOKENS = [PAD, EOS, UNK]
NUM_RESERVED_TOKENS = len(RESERVED_TOKENS)
PAD_ID = 0
EOS_ID = 1
UNK_ID = 2


class TextEncoder:
    """Base class for converting between text and integer ids."""

    def __init__(self, num_reserved_ids: int = NUM_RESERVED_TOKENS):
        self._num_reserved_ids = num_reserved_ids

    @property
    def num_reserved_ids(self):
        return self._num_reserved_ids

    def encode(self, s: str) -> List[int]:
        return [int(w) + self._num_reserved_ids for w in s.split()]

    def decode(self, ids: List[int], strip_padding: bool = False) -> str:
        if strip_padding:
            ids = [i for i in ids if i != PAD_ID]
        return " ".join(str(i - self._num_reserved_ids) for i in ids)

    @property
    def vocab_size(self):
        raise NotImplementedError


class TokenTextEncoder(TextEncoder):
    """Encoder based on a user-supplied vocabulary (token list)."""

    def __init__(self, vocab_list: Optional[List[str]] = None,
                 replace_oov: Optional[str] = None,
                 num_reserved_ids: int = NUM_RESERVED_TOKENS):
        super().__init__(num_reserved_ids=num_reserved_ids)
        self._replace_oov = replace_oov
        vocab_list = list(vocab_list or [])
        self._id_to_token = dict(enumerate(RESERVED_TOKENS[:num_reserved_ids]))
        for i, tok in enumerate(vocab_list):
            self._id_to_token[i + num_reserved_ids] = tok
        self._token_to_id = {t: i for i, t in self._id_to_token.items()}

    def encode(self, s: str) -> List[int]:
        tokens = s.strip().split()
        if self._replace_oov is not None:
            tokens = [t if t in self._token_to_id else self._replace_oov
                      for t in tokens]
        return [self._token_to_id[t] for t in tokens]

    def decode(self, ids, strip_padding: bool = False) -> str:
        if strip_padding:
            ids = [i for i in ids if i != PAD_ID]
        return " ".join(self._id_to_token.get(int(i), UNK) for i in ids)

    def decode_list(self, ids) -> List[str]:
        return [self._id_to_token.get(int(i), UNK) for i in ids]

    @property
    def vocab_size(self):
        return len(self._id_to_token)

    def __len__(self):
        return self.vocab_size

    def pad(self):
        return PAD_ID

    def eos(self):
        return EOS_ID

    def store_to_file(self, filename: str):
        with open(filename, "w", encoding="utf-8") as f:
            for i in range(len(self._id_to_token)):
                f.write(self._id_to_token[i] + "\n")


def build_token_encoder(token_list_file: str) -> TokenTextEncoder:
    import json

    token_list = json.load(open(token_list_file, encoding="utf-8"))
    return TokenTextEncoder(vocab_list=token_list, replace_oov="|")
