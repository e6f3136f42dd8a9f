r"""Pure-python PTB-style tokenizer (port of ``care_tpu/metrics/tokenizer.py``).

Replaces pycocoevalcap's Java ``PTBTokenizer`` subprocess (used by the
reference through ``misc/cocoeval.py:4-9``).  The COCO pipeline invokes
Stanford CoreNLP 3.4.1 ``edu.stanford.nlp.process.PTBTokenizer
-preserveLines -lowerCase`` and then drops tokens found in its
``PUNCTUATIONS`` list.  This module reproduces that pipeline's observable
behavior:

* **lexer normalisations** (PTBLexer defaults): brackets to
  ``-lrb-``/``-rrb-``/``-lsb-``/``-rsb-``/``-lcb-``/``-rcb-``, double
  quotes to ``\`\``` / ``''``, unicode quotes/dashes/ellipsis to their
  ASCII PTB forms, ``...`` kept as one token, ``--`` kept as one token,
  ``/`` and ``*`` escaped to ``\\/`` and ``\\*`` inside tokens (CoreNLP
  3.4.1 default ``escapeForwardSlashAsterisk=true``), ``£`` to ``#``
  (``normalizeCurrency``), ``&amp;`` to ``&``;
* **token shapes**: contractions split (``do n't``, ``it 's``), special
  multi-word splits (``can not``, ``gon na``), hyphen/ampersand/slash
  compounds kept as one token (``state-of-the-art``, ``at&t``,
  ``and\\/or``), decimals / number-commas / clock times kept as one token
  (``1,000``, ``3.5``, ``12:30``), dotted acronyms kept as one token
  (``u.s.``), currency symbols and ``%`` split off;
* **the COCO punctuation filter quirk**: the filter list contains
  *uppercase* ``-LRB-`` etc. while ``-lowerCase`` output is lowercase, so
  bracket tokens SURVIVE filtering in the real pipeline — they do here
  too.

Known deviations from the jar (documented, not silently different):
``americanize`` (British→US respelling) is not applied, and
sentence-final dotted-abbreviation period duplication is not modelled.
Both are exercised by no caption vocabulary in the reference datasets.
The golden corpus ``tests/golden/ptb_tokenizer_golden.json`` locks >100
cases derived from the PTBLexer spec.
"""

import re

# punctuation tokens the COCO wrapper removes AFTER tokenisation
# (pycocoevalcap PTBTokenizer.PUNCTUATIONS). The uppercase bracket entries
# are kept verbatim: lowercased lexer output never matches them, which is
# exactly why "-lrb-" survives in the real pipeline.
_PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                 ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = set(_PUNCTUATIONS)

# unicode -> PTB ASCII normalisation (PTBLexer latexQuotes/ptb3Dashes/
# ptb3Ellipsis defaults)
_UNICODE_MAP = {
    "’": "'", "‘": "'", "‛": "'",   # single quotes
    "“": ' " ', "”": ' " ',              # double quotes
    "–": "--", "—": "--",                # en/em dash
    "…": "...",                               # ellipsis
    " ": " ",                                 # nbsp
    "£": " # ",                               # £ -> # (normalizeCurrency)
}

_NT = re.compile(r"(?<=[a-z])n't\b")
_CONTRACTIONS = re.compile(r"([a-z])('(?:s|d|ll|re|ve|m))\b")
# PTBLexer's special multi-word splits (Stanford PTBLexer SPECIAL_CASES)
_SPECIAL_SPLITS = [
    (re.compile(r"\bcannot\b"), "can not"),
    (re.compile(r"\bgonna\b"), "gon na"),
    (re.compile(r"\bgotta\b"), "got ta"),
    (re.compile(r"\bwanna\b"), "wan na"),
    (re.compile(r"\blemme\b"), "lem me"),
    (re.compile(r"\bgimme\b"), "gim me"),
]
_BRACKETS = {"(": " -lrb- ", ")": " -rrb- ", "[": " -lsb- ", "]": " -rsb- ",
             "{": " -lcb- ", "}": " -rcb- "}

# ordered token scanner: first match wins, so protected shapes (acronyms,
# numbers with internal . , :) come before the generic word/char rules
_SCAN = re.compile(
    r"(?:[a-z]\.){2,}[a-z]?\.?"            # dotted acronyms: u.s., u.s.a.
    # 1,000  3.5  12:30  1,234.56 and number-word compounds like 3.5-star
    r"|\d+(?:[.,:]\d+)+(?:[-&'/][a-z0-9]+(?:[.,:]\d+)*)*"
    r"|n't|'(?:s|d|ll|re|ve|m)\b"          # pre-split contraction pieces
    r"|[a-z0-9]+(?:[-&'/][a-z0-9]+)*"      # words + hyphen/&/'/slash compounds
    r"|\.\.\.|--"                          # PTB ellipsis / dash tokens
    r"|-lrb-|-rrb-|-lsb-|-rsb-|-lcb-|-rcb-"
    r"|``|''"
    r"|\S"                                 # any other symbol, alone
)


def ptb_tokenize(caption: str):
    """Tokenize one caption -> list of tokens (COCO PTBTokenizer pipeline:
    Stanford-normalised, lowercased, punctuation-filtered)."""
    s = caption.lower().strip()
    for u, a in _UNICODE_MAP.items():
        if u in s:
            s = s.replace(u, a)
    s = s.replace("&amp;", "&")
    # double quotes become `` / '' in the lexer; both are filtered, so the
    # closing-form stand-in is outcome-equivalent
    s = s.replace('"', " '' ")
    for ch, tok in _BRACKETS.items():
        if ch in s:
            s = s.replace(ch, tok)
    s = _NT.sub(" n't", s)
    s = _CONTRACTIONS.sub(r"\1 \2", s)
    for pat, rep in _SPECIAL_SPLITS:
        s = pat.sub(rep, s)
    tokens = _SCAN.findall(s)
    out = []
    for t in tokens:
        if t in _PUNCT_SET:
            continue
        # CoreNLP 3.4.1 escapeForwardSlashAsterisk default
        if "/" in t:
            t = t.replace("/", "\\/")
        if "*" in t:
            t = t.replace("*", "\\*")
        out.append(t)
    return out


def tokenize_corpus(captions_for_image: dict) -> dict:
    """dict[id] -> list of {'caption': str}  =>  dict[id] -> list of str
    (space-joined tokenized captions), mirroring PTBTokenizer.tokenize."""
    out = {}
    for k, caps in captions_for_image.items():
        out[k] = [" ".join(ptb_tokenize(c["caption"])) for c in caps]
    return out
