"""A reader and a writer for the YAML that the configs use, with the
standard library only (the card's machine has no PyYAML).

``loads`` reads block mappings and block sequences nested by indentation
(``yaml.safe_dump`` writes lists as block sequences, so the configs that
the JAX package's ``train.py`` saves read too), ``#`` comments, flow lists ``[10, 60, 120]`` and flow mappings
``{method: l1, lambda: 0.8}`` (nested, on one line), and plain, single- and
double-quoted scalars. Plain scalars resolve as ``yaml.safe_load`` (YAML
1.1) resolves them: ints (decimal, ``0x`` hex, ``0`` octal, ``_``
separators), floats only with a dot (``1.0e-3``; ``1e-3`` stays a string),
``.inf`` / ``.nan``, the bool words (``true``, ``yes``, ``on``, ...), and
``null`` / ``~`` / nothing. Anchors, tags, multi-line scalars and
multi-document streams are not read and raise.

``dumps`` writes a config (dicts, lists, str, int, float, bool, None) that
``loads`` and ``yaml.safe_load`` both read back equal: mappings as blocks,
lists as flow sequences, strings double-quoted unless they read back as
themselves plain.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_INT = re.compile(r'''[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)
                      |0x[0-9a-fA-F_]+)$''', re.X)
_FLOAT = re.compile(r'''[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$
                        |\.[0-9_]+(?:[eE][-+][0-9]+)?$''', re.X)
_INF = re.compile(r'[-+]?\.(?:inf|Inf|INF)$')
_NAN = re.compile(r'\.(?:nan|NaN|NAN)$')
_TRUE = {'yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON'}
_FALSE = {'no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off', 'OFF'}
_NULL = {'', '~', 'null', 'Null', 'NULL'}
_PLAIN_KEY = re.compile(r'[A-Za-z_][A-Za-z0-9_.]*$')
# double-quoted escapes: single characters, and hex codes of 2, 4, 8 digits
_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', 'n': '\n',
            'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b', ' ': ' ',
            '"': '"', '/': '/', '\\': '\\', 'N': '\x85', '_': '\xa0',
            'L': '\u2028', 'P': '\u2029'}
_HEX = {'x': 2, 'u': 4, 'U': 8}


class YAMLError(ValueError):
    pass


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        s = text.replace('_', '')
        sign = -1 if s[0] == '-' else 1
        s = s.lstrip('+-')
        if s.startswith('0b'):
            return sign * int(s[2:], 2)
        if s.startswith('0x'):
            return sign * int(s[2:], 16)
        if len(s) > 1 and s[0] == '0':
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        return float(text.replace('_', ''))
    if _INF.match(text):
        return -math.inf if text[0] == '-' else math.inf
    if _NAN.match(text):
        return math.nan
    if text[0] in '&*!|>%@`':
        raise YAMLError(f'unsupported YAML syntax: {text!r}')
    return text


# ---------------------------------------------------------------- reading

def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a space,
    outside quotes), right-stripped."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == '\\' and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in '"\'':
            quote = c
        elif c == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Recursive-descent reader of one flow value or scalar."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in ' \t':
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ''

    def value(self, in_flow: bool) -> Any:
        self.ws()
        c = self.peek()
        if c == '[':
            return self.seq()
        if c == '{':
            return self.mapping()
        if c in '"\'':
            return self.quoted()
        return resolve_plain(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if in_flow and c in ',[]{}':
                break
            if c == ':' and in_flow and self.s[self.i + 1:self.i + 2] in (
                    ' ', ',', '}', ']', ''):
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise YAMLError(f'unterminated string in {self.s!r}')
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return ''.join(out)
            if q == '"' and c == '"':
                self.i += 1
                return ''.join(out)
            if q == '"' and c == '\\':
                k = self.s[self.i + 1:self.i + 2]
                if k in _ESCAPES:
                    out.append(_ESCAPES[k])
                    self.i += 2
                elif k in _HEX:
                    n = _HEX[k]
                    out.append(chr(int(self.s[self.i + 2:self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    raise YAMLError(f'unsupported escape \\{k} in {self.s!r}')
                continue
            out.append(c)
            self.i += 1

    def seq(self) -> list:
        self.i += 1
        out = []
        self.ws()
        if self.peek() == ']':
            self.i += 1
            return out
        while True:
            out.append(self.value(True))
            self.ws()
            c = self.peek()
            self.i += 1
            if c == ']':
                return out
            if c != ',':
                raise YAMLError(f'bad flow sequence {self.s!r}')
            self.ws()
            if self.peek() == ']':   # trailing comma
                self.i += 1
                return out

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        self.ws()
        if self.peek() == '}':
            self.i += 1
            return out
        while True:
            self.ws()
            key = self.quoted() if self.peek() in '"\'' else \
                resolve_plain(self.plain(True))
            self.ws()
            if self.peek() == ':':
                self.i += 1
                self.ws()
                val = None if self.peek() in ',}' else self.value(True)
            else:
                val = None
            out[key] = val
            self.ws()
            c = self.peek()
            self.i += 1
            if c == '}':
                return out
            if c != ',':
                raise YAMLError(f'bad flow mapping {self.s!r}')

    def done(self):
        self.ws()
        if self.i != len(self.s):
            raise YAMLError(f'trailing text in {self.s!r}')


def _scalar_or_flow(text: str) -> Any:
    f = _Flow(text)
    v = f.value(False)
    f.done()
    return v


def _split_key(text: str) -> Tuple[str, str]:
    """(key, rest) of a block mapping line ``key: rest``; raises when the
    line holds no mapping key."""
    if text[0] in '"\'':
        f = _Flow(text)
        key = f.quoted()
        rest = text[f.i:].lstrip()
        if not rest.startswith(':'):
            raise YAMLError(f'expected a mapping key in {text!r}')
        return key, rest[1:].strip()
    m = re.search(r':(?:\s|$)', text)
    if m is None:
        raise YAMLError(f'expected a mapping key in {text!r}')
    return resolve_plain(text[:m.start()].strip()), text[m.end():].strip()


def _is_item(text: str) -> bool:
    return text.startswith('- ') or text == '-'


def _is_key_line(text: str) -> bool:
    if text[0] in '"\'':
        f = _Flow(text)
        f.quoted()
        return text[f.i:].lstrip().startswith(':')
    if text[0] in '[{':
        return False
    return re.search(r':(?:\s|$)', text) is not None


def _block(lines: List[Tuple[int, str]], i: int, indent: int
           ) -> Tuple[Any, int]:
    """The block node whose lines start at ``lines[i]`` with ``indent``;
    returns (value, index of the next line)."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and \
                _is_item(lines[i][1]):
            rest = lines[i][1][1:].strip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    val, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    val, i = None, i + 1
            elif _is_key_line(rest):
                # "- key: v" opens a mapping whose lines sit at the dash's
                # indent + 2
                sub = indent + len(lines[i][1]) - len(rest)
                lines[i] = (sub, rest)
                val, i = _block(lines, i, sub)
            else:
                val, i = _scalar_or_flow(rest), i + 1
            out.append(val)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        if _is_item(text):
            raise YAMLError(f'sequence item inside a mapping: {text!r}')
        key, rest = _split_key(text)
        if rest:
            val, i = _scalar_or_flow(rest), i + 1
        elif i + 1 < len(lines) and (
                lines[i + 1][0] > indent
                or (lines[i + 1][0] == indent and _is_item(lines[i + 1][1]))):
            val, i = _block(lines, i + 1, lines[i + 1][0])
        else:
            val, i = None, i + 1
        if key in out:
            raise YAMLError(f'duplicate key {key!r}')
        out[key] = val
    return out, i


def loads(text: str) -> Any:
    """The value of one YAML document (None for an empty one)."""
    lines = []
    for raw in text.splitlines():
        if '\t' in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLError('tab in indentation')
        body = _strip_comment(raw)
        if not body.strip() or body.strip() in ('---', '...'):
            continue
        lines.append((len(body) - len(body.lstrip(' ')), body.strip()))
    if not lines:
        return None
    if len(lines) == 1 and not _is_key_line(lines[0][1]) \
            and not _is_item(lines[0][1]):
        return _scalar_or_flow(lines[0][1])
    val, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YAMLError(f'bad indentation at {lines[i][1]!r}')
    return val


# ---------------------------------------------------------------- writing

def _scalar(v: Any) -> str:
    if v is None:
        return 'null'
    if v is True or v is False:
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return '.nan'
        if math.isinf(v):
            return '.inf' if v > 0 else '-.inf'
        text = repr(v)
        mant, _, exp = text.partition('e')
        if '.' not in mant:
            mant += '.0'
        if exp and exp[0] not in '+-':
            exp = '+' + exp
        return mant + ('e' + exp if exp else '')
    if isinstance(v, str):
        try:
            plain_ok = (_PLAIN_KEY.match(v) is not None
                        and resolve_plain(v) == v)
        except YAMLError:
            plain_ok = False
        return v if plain_ok else json.dumps(v, ensure_ascii=False)
    raise TypeError(f'cannot write {type(v).__name__} as YAML')


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return '{' + ', '.join(f'{_scalar(k)}: {_flow(x)}'
                               for k, x in v.items()) + '}'
    if isinstance(v, (list, tuple)):
        return '[' + ', '.join(_flow(x) for x in v) + ']'
    return _scalar(v)


def dumps(cfg: Any, indent: int = 0) -> str:
    """``cfg`` as YAML text: mappings as blocks, everything else flow."""
    if not isinstance(cfg, dict):
        return ' ' * indent + _flow(cfg) + '\n'
    out = []
    for k, v in cfg.items():
        head = ' ' * indent + _scalar(k) + ':'
        if isinstance(v, dict) and v:
            out.append(head + '\n' + dumps(v, indent + 2))
        else:
            out.append(head + ' ' + _flow(v) + '\n')
    return ''.join(out)
