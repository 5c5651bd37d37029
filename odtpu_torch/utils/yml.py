"""A reader of the YAML that configuration files use, without PyYAML.

:func:`loads` turns a yml's text into the tree that ``yaml.safe_load``
gives (PyYAML's YAML 1.1 rules), for this subset:

- block mappings by indentation, and block sequences (``- item``), a
  sequence also at its key's own indentation;
- flow sequences and mappings, nested (``[[2, 3], [2]]``,
  ``{a: 1}``), over several lines if need be;
- single-quoted (``''`` is a quote) and double-quoted strings, with
  YAML's escapes;
- plain scalars, which may hold ``,``, ``(`` and ``'`` outside a flow
  collection (``(('2007', 'trainval'),)`` stays a string), resolved as
  PyYAML resolves them: ``yes/no/true/false/on/off`` in their three
  cases are booleans, ``~``, ``null`` and an empty value are ``None``,
  ints in bases 2, 8, 10 and 16 and in base 60 (``1:30``), ``_``
  between digits; a float needs a dot (``1e-3`` stays a string), and
  ``.inf`` and ``.nan`` are floats;
- comments: a ``#`` at the start of a line or after a blank, outside
  quotes; blank lines; a leading ``---``.

Anything else raises :class:`YmlError` naming the line: anchors,
aliases, tags, block scalars (``|``, ``>``), complex keys (``?``),
directives, a second document, a tab in the indentation, a timestamp, a
quoted string over several lines. Nothing is skipped quietly.
"""

from __future__ import annotations

import re

_BOOL = {v: b for b, words in ((True, ("yes", "true", "on")),
                               (False, ("no", "false", "off")))
         for w in words for v in (w, w.capitalize(), w.upper())}
_NULL = ("", "~", "null", "Null", "NULL")
# PyYAML's implicit resolvers (resolver.py), verbatim
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]"
                        r":[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]"
                        r"[0-9]?(?::[0-9][0-9])?))?)?$")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}
_FLOW = ",[]{}"
_REFUSED = {"&": "an anchor", "*": "an alias", "!": "a tag",
            "|": "a block scalar", ">": "a block scalar",
            "%": "a directive", "@": "a reserved indicator",
            "`": "a reserved indicator"}


class YmlError(ValueError):
    """A yml outside the reader's subset, or not YAML; names the line."""


def resolve(text: str):
    """A plain scalar as PyYAML's SafeLoader constructs it."""
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _TIMESTAMP.match(text):
        raise ValueError("a timestamp ({!r}) is not read".format(text))
    return text


def _sexagesimal(digits: list) -> float:
    value = 0
    for part in digits:
        value = value * 60 + part
    return value


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal([int(p) for p in v.split(":")])
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal([float(p) for p in v.split(":")])
    return sign * float(v)


class _Reader:
    """The document as one string, with the line of every position."""

    def __init__(self, text: str, name: str):
        self.text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.name = name
        self.starts = [0] + [m.end() for m in re.finditer("\n", self.text)]

    def line_of(self, pos: int) -> int:
        lo, hi = 0, len(self.starts) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.starts[mid] <= pos:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def end_of_line(self, line: int) -> int:
        if line + 1 < len(self.starts):
            return self.starts[line + 1] - 1
        return len(self.text)

    def error(self, pos: int, what: str) -> YmlError:
        return YmlError("{}:{}: {}".format(self.name, self.line_of(pos) + 1,
                                           what))


def _blank(c: str) -> bool:
    return c in " \t\n"


class _Parser:
    def __init__(self, text: str, name: str):
        self.r = _Reader(text, name)
        self.lines = self._lines()

    # --- the lines that hold content: (line, indent, position) ---

    def _lines(self) -> list:
        r = self.r
        out, started, ended = [], False, False
        for i, start in enumerate(r.starts):
            end = r.end_of_line(i)
            raw = r.text[start:end]
            body = raw.lstrip(" ")
            indent = len(raw) - len(body)
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            if body.startswith("\t"):
                raise r.error(start, "a tab in the indentation")
            if indent == 0 and re.match(r"(---|\.\.\.)(\s|$)", body):
                if body.startswith("..."):
                    ended = True
                    continue
                if started:
                    raise r.error(start, "a second document")
                rest = body[3:].strip()
                if rest and not rest.startswith("#"):
                    raise r.error(start, "content after '---'")
                started = True
                continue
            if ended:
                raise r.error(start, "a second document")
            if indent == 0 and body.startswith("%"):
                raise r.error(start, "a directive")
            started = True
            out.append((i, indent, start + indent))
        return out

    def parse(self):
        if not self.lines:
            return None
        value, k = self._block(0, self.lines[0][1])
        if k < len(self.lines):
            raise self.r.error(self.lines[k][2], "content outside the "
                               "document's top node")
        return value

    # --- block nodes ---

    def _block(self, k: int, indent: int):
        """The block node whose first line is ``self.lines[k]`` at
        ``indent``: (value, index of the first line after it)."""
        _, _, pos = self.lines[k]
        if self._is_item(pos):
            return self._sequence(k, indent)
        if self._key_end(pos) is not None:
            return self._mapping(k, indent)
        value, end = self._inline(pos, "block")
        return value, self._after(end, k)

    def _is_item(self, pos: int) -> bool:
        t = self.r.text
        return t[pos] == "-" and (pos + 1 >= len(t) or _blank(t[pos + 1]))

    def _sequence(self, k: int, indent: int):
        out = []
        while k < len(self.lines) and self.lines[k][1] == indent \
                and self._is_item(self.lines[k][2]):
            line, _, pos = self.lines[k]
            value, k = self._entry(k, pos + 1, indent, line)
            out.append(value)
        return out, k

    def _mapping(self, k: int, indent: int):
        out = {}
        while k < len(self.lines) and self.lines[k][1] == indent:
            line, _, pos = self.lines[k]
            if self._is_item(pos):
                raise self.r.error(pos, "a sequence item where a key was "
                                   "expected")
            key_end = self._key_end(pos)
            if key_end is None:
                raise self.r.error(pos, "a line that is no 'key: value' "
                                   "inside a mapping")
            key, colon = key_end
            value, k = self._entry(k, colon + 1, indent, line,
                                   same_indent_seq=True)
            out[key] = value
        return out, k

    def _entry(self, k: int, pos: int, indent: int, line: int,
               same_indent_seq: bool = False):
        """The value that follows a key's ``:`` or an item's ``-`` at
        ``pos`` on ``self.lines[k]``: inline, or the block on the next
        lines (more indented; for a key also a sequence at its own
        indentation)."""
        t, r = self.r.text, self.r
        eol = r.end_of_line(line)
        p = pos
        while p < eol and t[p] in " \t":
            p += 1
        if p < eol and t[p] != "#":
            if self._is_item(p) or self._key_end(p) is not None:
                if same_indent_seq:
                    raise r.error(p, "a mapping or sequence after a key on "
                                  "its line")
                # an item that is itself a mapping or sequence: its
                # column is its indentation
                col = p - r.starts[line]
                self.lines[k] = (line, col, p)
                return self._block(k, col)
            value, end = self._inline(p, "block")
            return value, self._after(end, k)
        k += 1
        if k < len(self.lines):
            nxt_indent, nxt_pos = self.lines[k][1], self.lines[k][2]
            if nxt_indent > indent or (same_indent_seq
                                       and nxt_indent == indent
                                       and self._is_item(nxt_pos)):
                return self._block(k, nxt_indent)
        return None, k

    def _after(self, end: int, k: int) -> int:
        """Check that only blanks and a comment follow a node ending at
        ``end``; the index of the first content line after it."""
        t, r = self.r.text, self.r
        line = r.line_of(end) if end < len(t) else len(r.starts) - 1
        eol = r.end_of_line(line)
        p = end
        while p < eol and t[p] in " \t":
            p += 1
        if p < eol and not (t[p] == "#" and (p == end or _blank(t[p - 1]))):
            raise r.error(p, "unexpected {!r} after a value".format(
                t[p:eol].strip()))
        while k < len(self.lines) and self.lines[k][0] <= line:
            k += 1
        return k

    def _key_end(self, pos: int):
        """(key, position of its ':') when the line at ``pos`` is a
        mapping entry, else None."""
        t, r = self.r.text, self.r
        eol = r.end_of_line(r.line_of(pos))
        c = t[pos]
        if c == "?" and (pos + 1 >= len(t) or _blank(t[pos + 1])):
            raise r.error(pos, "a complex key ('?')")
        if c in "'\"":
            key, p = self._quoted(pos)
            q = p
            while q < eol and t[q] in " \t":
                q += 1
            if q < eol and t[q] == ":" and (q + 1 >= len(t)
                                            or _blank(t[q + 1])):
                return key, q
            return None
        if c in "[{":
            return None
        p = pos
        while p < eol:
            if t[p] == "#" and p > pos and _blank(t[p - 1]):
                return None
            if t[p] == ":" and (p + 1 >= len(t) or _blank(t[p + 1])):
                text = t[pos:p].rstrip(" \t")
                if not text:
                    raise r.error(pos, "an empty key")
                self._plain_start(pos)
                try:
                    return resolve(text), p
                except ValueError as e:
                    raise r.error(pos, str(e)) from None
            p += 1
        return None

    # --- inline nodes ---

    def _plain_start(self, pos: int) -> None:
        c = self.r.text[pos]
        if c in _REFUSED:
            raise self.r.error(pos, "{} ({!r}) is not read".format(
                _REFUSED[c], c))

    def _inline(self, pos: int, context: str):
        """The node that starts at ``pos`` (a flow collection, a quoted
        string or a plain scalar) in ``context`` "block" or "flow":
        (value, position after it)."""
        t = self.r.text
        c = t[pos]
        if c == "[":
            return self._flow_seq(pos)
        if c == "{":
            return self._flow_map(pos)
        if c in "'\"":
            return self._quoted(pos)
        self._plain_start(pos)
        return self._plain(pos, context)

    def _plain(self, pos: int, context: str):
        t, r = self.r.text, self.r
        eol = r.end_of_line(r.line_of(pos))
        p = pos
        while p < eol:
            c = t[p]
            if c == "#" and p > pos and _blank(t[p - 1]):
                break
            if c == ":" and (p + 1 >= len(t) or _blank(t[p + 1])
                             or (context == "flow" and t[p + 1] in _FLOW)):
                if context == "block":
                    raise r.error(p, "a mapping value where a scalar "
                                  "goes (': ' inside a plain scalar)")
                break
            if context == "flow" and c in _FLOW:
                break
            p += 1
        text = t[pos:p].rstrip(" \t")
        end = pos + len(text)
        if context == "block":
            nxt = self._continues(end)
            if nxt is not None:
                raise r.error(nxt, "a plain scalar over several lines")
        try:
            return resolve(text), end
        except ValueError as e:
            raise r.error(pos, str(e)) from None

    def _continues(self, end: int):
        """Where the next content line starts, when it is more indented
        than the line of ``end`` and is neither a key nor an item (a
        plain scalar's continuation), else None."""
        r = self.r
        line = r.line_of(end)
        for i, indent, pos in self.lines:
            if i <= line:
                continue
            first = r.starts[line]
            own = len(r.text[first:r.end_of_line(line)]) - len(
                r.text[first:r.end_of_line(line)].lstrip(" "))
            if indent > own and not self._is_item(pos) \
                    and self._key_end(pos) is None:
                return pos
            return None
        return None

    def _quoted(self, pos: int):
        t, r = self.r.text, self.r
        q = t[pos]
        out, p = [], pos + 1
        while True:
            if p >= len(t):
                raise r.error(pos, "an unterminated quoted string")
            c = t[p]
            if c == "\n":
                raise r.error(pos, "a quoted string over several lines")
            if q == "'":
                if c == "'":
                    if p + 1 < len(t) and t[p + 1] == "'":
                        out.append("'")
                        p += 2
                        continue
                    return "".join(out), p + 1
                out.append(c)
                p += 1
                continue
            if c == '"':
                return "".join(out), p + 1
            if c == "\\":
                e = t[p + 1] if p + 1 < len(t) else ""
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    p += 2
                    continue
                if e in _HEX:
                    n = _HEX[e]
                    digits = t[p + 2:p + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        raise r.error(p, "a bad escape \\{}{}".format(
                            e, digits))
                    out.append(chr(int(digits, 16)))
                    p += 2 + n
                    continue
                raise r.error(p, "an unknown escape \\{}".format(e))
            out.append(c)
            p += 1

    def _skip(self, p: int) -> int:
        """Past blanks, line breaks and comments inside a flow
        collection."""
        t = self.r.text
        while p < len(t):
            if t[p] in " \t\n":
                p += 1
            elif t[p] == "#" and (p == 0 or _blank(t[p - 1])):
                while p < len(t) and t[p] != "\n":
                    p += 1
            else:
                break
        return p

    def _flow_seq(self, pos: int):
        t, r = self.r.text, self.r
        out, p = [], self._skip(pos + 1)
        while True:
            if p >= len(t):
                raise r.error(pos, "an unclosed '['")
            if t[p] == "]":
                return out, p + 1
            value, p = self._flow_node(p)
            if p < len(t) and t[p] == ":" and (
                    p + 1 >= len(t) or _blank(t[p + 1])
                    or t[p + 1] in _FLOW):
                raise r.error(p, "a mapping inside a flow sequence")
            out.append(value)
            p = self._skip(p)
            if p < len(t) and t[p] == ",":
                p = self._skip(p + 1)
            elif p < len(t) and t[p] != "]":
                raise r.error(p, "expected ',' or ']'")

    def _flow_map(self, pos: int):
        t, r = self.r.text, self.r
        out, p = {}, self._skip(pos + 1)
        while True:
            if p >= len(t):
                raise r.error(pos, "an unclosed '{'")
            if t[p] == "}":
                return out, p + 1
            key, p = self._flow_node(p)
            p = self._skip(p)
            value = None
            if p < len(t) and t[p] == ":":
                p = self._skip(p + 1)
                if p < len(t) and t[p] not in ",}":
                    value, p = self._flow_node(p)
                    p = self._skip(p)
            out[key] = value
            if p < len(t) and t[p] == ",":
                p = self._skip(p + 1)
            elif p < len(t) and t[p] != "}":
                raise r.error(p, "expected ',' or '}'")

    def _flow_node(self, p: int):
        t, r = self.r.text, self.r
        if t[p] in ",]}":
            raise r.error(p, "an empty entry in a flow collection")
        if t[p] in "-?:" and p + 1 < len(t) and _blank(t[p + 1]):
            raise r.error(p, "{!r} inside a flow collection".format(t[p]))
        return self._inline(p, "flow")


def loads(text: str, name: str = "<yml>"):
    """The tree of the yml ``text`` (``name`` labels the errors)."""
    return _Parser(text, name).parse()


def load(path: str):
    """The tree of the yml file at ``path``."""
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read(), path)
