"""SQL lexer: hand-rolled tokenizer (reference uses sqlparser-rs).

Produces a flat token stream of keywords, identifiers, literals, operators
and punctuation. Case-insensitive keywords; identifiers can be quoted with
double quotes or backticks; strings are single-quoted with '' escaping.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from greptimedb_tpu_torch.errors import SyntaxError_


class Tok(enum.Enum):
    IDENT = "IDENT"
    QUOTED_IDENT = "QUOTED_IDENT"
    STRING = "STRING"
    NUMBER = "NUMBER"
    OP = "OP"
    PUNCT = "PUNCT"
    EOF = "EOF"


@dataclass(frozen=True)
class Token:
    kind: Tok
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


_TWO_CHAR_OPS = ("<=", ">=", "!=", "<>", "||", "!~", "=~")
_ONE_CHAR_OPS = "+-*/%<>=~"
_PUNCT = "(),.;[]{}:@#"


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SyntaxError_(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            else:
                raise SyntaxError_(f"unterminated string at {i}")
            toks.append(Token(Tok.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c in ('"', "`"):
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise SyntaxError_(f"unterminated quoted identifier at {i}")
            toks.append(Token(Tok.QUOTED_IDENT, sql[i + 1 : j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                        seen_exp = True
                        j += 2
                    else:
                        break
                else:
                    break
            toks.append(Token(Tok.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            toks.append(Token(Tok.IDENT, sql[i:j], i))
            i = j
            continue
        matched = False
        for op in _TWO_CHAR_OPS:
            if sql.startswith(op, i):
                toks.append(Token(Tok.OP, op, i))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in _ONE_CHAR_OPS:
            toks.append(Token(Tok.OP, c, i))
            i += 1
            continue
        if c in _PUNCT:
            toks.append(Token(Tok.PUNCT, c, i))
            i += 1
            continue
        if c == "$":  # positional params $1 (pg wire); treat as ident
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            toks.append(Token(Tok.IDENT, sql[i:j], i))
            i = j
            continue
        raise SyntaxError_(f"unexpected character {c!r} at {i}")
    toks.append(Token(Tok.EOF, "", n))
    return toks
