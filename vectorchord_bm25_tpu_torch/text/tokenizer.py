"""`to_tsvector`-style English tokenizer.

Reproduces the PostgreSQL behavior the reference indexes through
(`to_tsvector('english', ...)`, SURVEY.md §2.9): the default parser's word
segmentation (including hyphenated compounds, which emit the whole
compound followed by its parts, each consuming one position), the
snowball English stopword list, and Porter2 stemming.  Tokens containing
digits are kept unstemmed (numword behavior); position counts are capped
at 256 per lexeme like PostgreSQL's tsvector.

The engine itself is tokenizer-agnostic (it consumes (lexeme, count)
pairs); this module exists for parity testing and batteries-included use.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

from .porter2 import stem

__all__ = ["STOPWORDS", "tsvector", "tokenize_query"]

# Snowball English stopword list (= PostgreSQL english.stop).
STOPWORDS = frozenset(
    """
    i me my myself we our ours ourselves you your yours yourself yourselves
    he him his himself she her hers herself it its itself they them their
    theirs themselves what which who whom this that these those am is are
    was were be been being have has had having do does did doing a an the
    and but if or because as until while of at by for with about against
    between into through during before after above below to from up down
    in out on off over under again further then once here there when where
    why how all any both each few more most other some such no nor not
    only own same so than too very s t can will just don should now
    """.split()
)

# Default-parser segmentation, covering PostgreSQL's token classes
# (src/backend/tsearch/wparser_def.c behavior, observed through
# to_tsvector('english', ...)):
#
#   email                   kept whole, lowercased (simple dict)
#   protocol + url          url emits url + host + url_path lexemes
#   host                    bare dotted names ('example.com', 'foo.txt')
#   file                    absolute /paths kept whole
#   version/float/uint      digit tokens kept verbatim
#   asciihword/hword        compound whole + its parts
#   numword/hword_numpart   tokens containing digits: lowercased verbatim
#   asciiword/word          Unicode letters, snowball-stemmed
#
# Word characters are Unicode letters/digits ([^\W_]); underscore and
# apostrophe are separators (PostgreSQL: "don't" -> "don" + "t", both
# stopwords; "foo_bar" -> "foo" + "bar").
_HAS_DIGIT = re.compile(r"\d")
_HOST = r"(?:[A-Za-z0-9_-]+\.)+[A-Za-z0-9_-]*[A-Za-z][A-Za-z0-9_-]*"
_SPECIAL = re.compile(
    rf"""
    (?P<email>[A-Za-z0-9._-]+@(?:[A-Za-z0-9_-]+\.)+[A-Za-z0-9_-]+)
  | (?P<url>
        [A-Za-z][A-Za-z0-9+.-]*://[A-Za-z0-9._-]+(?:/[^\s<>"']*)?
      | {_HOST}/[^\s<>"']*
    )
  | (?P<path>/(?:[A-Za-z0-9_.-]+/)*[A-Za-z0-9_.-]+)
  | (?P<version>[0-9]+(?:\.[0-9]+)+)
  | (?P<host>{_HOST})
    """,
    re.VERBOSE,
)
_WORDS = re.compile(r"[^\W_]+(?:-[^\W_]+)*")
_PROTOCOL = re.compile(r"[A-Za-z][A-Za-z0-9+.-]*://")


def _segment(text: str) -> List[str]:
    """Emit tokens in position order.

    A hyphenated compound emits the whole followed by its parts
    (PostgreSQL default parser: to_tsvector('english','quick-brown fox') =
    'quick-brown':1 'quick':2 'brown':3 'fox':4); a URL emits the url,
    host, and url_path lexemes; emails, bare hosts, file paths, and
    dotted numbers stay single lexemes, mirroring PostgreSQL's
    email/url/host/file/version token classes.
    """
    out: List[str] = []
    spans: List[tuple] = []
    for m in _SPECIAL.finditer(text):
        spans.append((m.start(), m.end(), m.lastgroup, m.group(0)))

    def emit_words(chunk: str):
        for m in _WORDS.finditer(chunk):
            tok = m.group(0)
            if "-" in tok:
                out.append(tok)
                out.extend(tok.split("-"))
            else:
                out.append(tok)

    last = 0
    for start, end, kind, tok in spans:
        emit_words(text[last:start])
        tok = tok.rstrip(".,;:!?")
        if kind == "url":
            rest = _PROTOCOL.sub("", tok, count=1)
            host, slash, path = rest.partition("/")
            if slash:
                out.extend([rest, host, slash + path])
            else:
                out.append(host)  # protocol://host with no path
        else:
            out.append(tok)
        last = end
    emit_words(text[last:])
    return out


def _normalize(token: str) -> str | None:
    """Lowercase, stopword-filter, stem. None = dropped (stopword)."""
    low = token.lower()
    if low in STOPWORDS:
        return None
    if _HAS_DIGIT.search(low) or "@" in low or "/" in low or "." in low:
        return low  # numword/email/url/host/path behavior: kept verbatim
    # Hyphenated compounds are stemmed whole, like PostgreSQL
    # ('object-relational' -> 'object-rel'): snowball suffix-strips the
    # string tail, hyphens just read as consonants.
    return stem(low)


def tsvector(text: str) -> Dict[str, int]:
    """lexeme -> number of positions (capped at 256), like casting the
    reference's tsvector input (src/datatype/tsvector.rs:84-94: value =
    position count)."""
    counts: Dict[str, int] = {}
    for token in _segment(text):
        lex = _normalize(token)
        if lex is None:
            continue
        counts[lex] = min(counts.get(lex, 0) + 1, 256)
    return counts


def tokenize_query(text: str) -> List[str]:
    """Distinct lexemes of a query string (sorted-unique handled by Query)."""
    return list(tsvector(text).keys())
