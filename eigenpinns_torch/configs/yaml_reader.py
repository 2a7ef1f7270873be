"""A reader for the sectioned YAML subset of the reference's config files.

`src/parameters.yml` is a mapping of sections, each a mapping of
`key: value`; values are scalars or lists. This module reads that subset
without PyYAML and returns what `yaml.safe_load` returns on it, PyYAML's
YAML 1.1 readings included:

  * top-level plain keys holding a section (a block mapping one level
    deep) or a value, with `#` comments and blank lines;
  * lists in flow form (`[256, 512]`, nested, a trailing comma allowed)
    or as block sequences of scalars or flow lists (`- 256`, at the key's
    indent or deeper);
  * plain scalars resolved as PyYAML resolves them: null (`~`, `null`,
    empty), booleans (`true`/`false`, `yes`/`no`, `on`/`off` in three
    casings), decimal ints, floats (a dot is required, and an exponent
    needs a sign: `1e-3` and `1.0e3` stay strings, `1.0e-3` is a float;
    `.inf`, `.nan`), everything else a string;
  * single-quoted (`''` for a quote) and double-quoted strings without
    backslashes, on one line.

Anything else raises ValueError naming the line, rather than being read
some other way: the ints and floats PyYAML reads in other forms (`0x1F`,
`017`, `0b101`, `1_000`, base 60 `1:30`), backslash escapes, mappings
nested below a section, quoted keys, document markers and directives,
flow mappings, anchors, aliases, tags, block scalars, multi-line
scalars, complex keys, merge keys, timestamps, tabs outside quotes.
"""

from __future__ import annotations

import re
from typing import Any

# PyYAML's YAML 1.1 resolvers, which say what PyYAML would read a plain
# scalar as; only the decimal ints and the plain floats among them are
# read here.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# Characters that cannot start a plain scalar in this subset.
_NOT_PLAIN = set(",[]{}#&*!|>'\"%@`")


class _Error(ValueError):
    pass


def _fail(lineno: int, what: str):
    raise _Error(f"line {lineno}: {what}")


def resolve_plain(text: str, lineno: int = 0) -> Any:
    """A plain (unquoted) scalar as PyYAML's safe loader reads it, tried
    in PyYAML's order; the forms this subset leaves out raise."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        if "_" in text or ":" in text:
            _fail(lineno, f"float form {text!r} is not supported")
        # Python reads "inf" and "nan", with a sign, but not YAML's dot.
        return float(text.replace(".", "") if text[-1] in "fFnN" else text)
    if _INT.match(text):
        if not _DECIMAL.match(text):
            _fail(lineno, f"int form {text!r} is not supported (decimal "
                  "only)")
        return int(text)
    if text == "<<":
        _fail(lineno, "merge keys are not supported")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        _fail(lineno, f"timestamp {text!r} is not supported")
    if text == "=":
        _fail(lineno, "the value tag '=' is not supported")
    return text


class _Line:
    """One line with content: its number, indent and text after the
    indent (comments are removed by the parser, which knows quotes)."""

    def __init__(self, lineno: int, indent: int, text: str):
        self.lineno, self.indent, self.text = lineno, indent, text

    def is_item(self) -> bool:
        return self.text == "-" or self.text.startswith("- ")


class _Scanner:
    """Scalars and flow lists from one line's text, from position `pos`."""

    def __init__(self, line: _Line):
        self.line, self.s, self.pos = line, line.text, 0

    def fail(self, what: str):
        _fail(self.line.lineno, what)

    def skip_spaces(self):
        while self.pos < len(self.s) and self.s[self.pos] == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment."""
        self.skip_spaces()
        return self.pos >= len(self.s) or self.s[self.pos] == "#"

    def expect_end(self):
        if not self.at_end():
            self.fail(f"unexpected text {self.s[self.pos:]!r}")

    def quoted(self) -> str:
        """A quoted string ending on its line: in single quotes `''` is a
        quote, and in double quotes a backslash raises."""
        quote, out = self.s[self.pos], []
        while True:
            end = self.s.find(quote, self.pos + 1)
            if end < 0:
                self.fail("unterminated quoted string (a quoted string "
                          "must end on its line)")
            out.append(self.s[self.pos + 1:end])
            self.pos = end + 1
            if quote == '"' or self.s[self.pos:self.pos + 1] != "'":
                break
            out.append("'")
        if quote == '"' and "\\" in out[0]:
            self.fail("backslash escapes are not supported")
        return "".join(out)

    def plain(self, flow: bool) -> Any:
        """A plain scalar: up to a comment or the line's end, and in a
        flow list also up to ',' or ']'."""
        c = self.s[self.pos]
        nxt = self.s[self.pos + 1:self.pos + 2]
        if c in _NOT_PLAIN or (c in "-?:" and nxt in ("", " ")):
            self.fail(f"{self.s[self.pos:]!r} is outside the supported "
                      "subset")
        start = self.pos
        while self.pos < len(self.s):
            c = self.s[self.pos]
            if c == "#" and self.s[self.pos - 1] == " ":
                break
            if c == "\t":
                self.fail("tabs outside quoted strings are not supported")
            after = self.s[self.pos + 1:self.pos + 2]
            if c == ":" and (after in ("", " ")
                             or (flow and after in ",[]{}")):
                self.fail("a mapping is not allowed here (': ' in a "
                          "value)")
            if flow and c in ",[]{}":
                break
            self.pos += 1
        return resolve_plain(self.s[start:self.pos].rstrip(" "),
                             self.line.lineno)

    def flow_list(self) -> list:
        self.pos += 1   # '['
        items = []
        while True:
            self.skip_spaces()
            if self.pos >= len(self.s) or self.s[self.pos] == "#":
                self.fail("unterminated flow list (a flow list must end "
                          "on its line)")
            c = self.s[self.pos]
            if c == "]":
                self.pos += 1
                return items
            items.append(self.value(flow=True))
            self.skip_spaces()
            c = self.s[self.pos:self.pos + 1]
            if c == ",":
                self.pos += 1
            elif c != "]":
                self.fail(f"expected ',' or ']' in a flow list, found "
                          f"{self.s[self.pos:]!r}")

    def value(self, flow: bool = False) -> Any:
        c = self.s[self.pos]
        if c == "[":
            return self.flow_list()
        if c in "'\"":
            return self.quoted()
        if c == "{":
            self.fail("flow mappings are not supported")
        return self.plain(flow)


def _strip(raw: str, lineno: int) -> _Line | None:
    """The line's indent and text, or None for a blank or comment line."""
    text = raw.rstrip("\r")
    body = text.lstrip(" ")
    indent = len(text) - len(body)
    if body.startswith("\t"):
        _fail(lineno, "tabs are not allowed in the indentation")
    if not body.strip(" \t") or body.startswith("#"):
        return None
    return _Line(lineno, indent, body)


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines, self.i = lines, 0

    def peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def inline(self, sc: _Scanner, line: _Line) -> tuple[bool, Any]:
        """The value after a key's ':' or an item's '-' on the same line:
        (True, the scalar or flow list), or (False, None) when the line
        ends there."""
        if sc.at_end():
            return False, None
        value = sc.value()
        sc.expect_end()
        nxt = self.peek()
        if nxt is not None and nxt.indent > line.indent:
            _fail(nxt.lineno, "continuation lines (multi-line scalars) "
                  "are not supported")
        return True, value

    def mapping(self, indent: int, section: bool = False) -> dict:
        """The document's mapping, or with `section` one of its sections,
        below which no mapping nests."""
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.lineno, "unexpected indentation")
            if line.is_item():
                _fail(line.lineno, "a list item where a key was expected")
            self.i += 1
            sc = _Scanner(line)
            key = self.key(sc)
            sc.pos += 1   # ':'
            has_value, value = self.inline(sc, line)
            if not has_value:
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    if nxt.is_item():
                        value = self.sequence(nxt.indent)
                    elif section:
                        _fail(nxt.lineno, "mappings nested below a section "
                              "are not supported")
                    else:
                        value = self.mapping(nxt.indent, section=True)
                elif (nxt is not None and nxt.indent == indent
                      and nxt.is_item()):
                    value = self.sequence(indent)
            out[key] = value

    def key(self, sc: _Scanner) -> Any:
        """A plain key, resolved as a plain scalar is."""
        c = sc.s[0]
        if c in _NOT_PLAIN or (c in "?:" and sc.s[1:2] in ("", " ")):
            sc.fail(f"{sc.s!r} is outside the supported subset (keys are "
                    "plain)")
        m = re.search(r":(?: |$)", sc.s)
        comment = re.search(r" #", sc.s)
        if m is None or (comment and comment.start() < m.start()):
            sc.fail(f"{sc.s!r} is not a 'key: value' line")
        if "\t" in sc.s[:m.start()]:
            sc.fail("tabs outside quoted strings are not supported")
        sc.pos = m.start()
        return resolve_plain(sc.s[:m.start()].rstrip(" "), sc.line.lineno)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.lineno, "unexpected indentation")
            if not line.is_item():
                return out
            self.i += 1
            sc = _Scanner(line)
            sc.pos = 1
            has_value, value = self.inline(sc, line)
            nxt = self.peek()
            if not has_value and nxt is not None and nxt.indent > indent:
                _fail(nxt.lineno, "nested blocks under a list item are "
                      "not supported")
            out.append(value)


def loads(text: str) -> Any:
    """The document in `text`, as `yaml.safe_load` reads it (None for an
    empty document); ValueError outside the subset."""
    if text.startswith("\ufeff"):
        text = text[1:]
    lines: list[_Line] = []
    for lineno, raw in enumerate(text.split("\n"), start=1):
        line = _strip(raw, lineno)
        if line is None:
            continue
        if line.indent == 0 and re.match(r"(?:%|---|\.\.\.)", line.text):
            _fail(lineno, "directives and document markers are not "
                  "supported")
        lines.append(line)
    if not lines:
        return None
    if lines[0].is_item():
        _fail(lines[0].lineno, "the document must be a mapping of sections")
    parser = _Parser(lines)
    out = parser.mapping(lines[0].indent)
    rest = parser.peek()
    if rest is not None:
        _fail(rest.lineno, "unexpected indentation")
    return out


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as fh:
        return loads(fh.read())
