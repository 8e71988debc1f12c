"""Tokenizer for ZK-IR v3.4 assembly.

Host copy of ``zkir_tpu/asm/lexer.py``.

Parity target: reference ``zkir-assembler/src/lexer.rs`` — the same token
classes (identifier, register, decimal/hex/binary numbers, ``.directive``,
punctuation) with ``#`` comments and maximal-munch word classification
(a word is a Register token iff it is ``r0``-``r15`` or one of the
assembler's alias names; otherwise an Identifier).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

from ..spec.registers import REG_ALIASES


@dataclass(frozen=True)
class Token:
    kind: str  # ident | reg | num | comma | colon | lparen | rparen | directive
    text: str
    value: int = 0
    base: int = 10  # for num tokens: 10 | 16 | 2 (reference Number/Hex/Binary)

    def rust_debug(self) -> str:
        """The reference token's Rust ``{:?}`` Debug text — assembler
        error messages embed it (assembler.rs:222-226, 504-534), so exact
        message parity needs the exact rendering: ``Identifier("x")``,
        ``Number(5)``, ``Hex(255)``, ``Comma``, ..."""
        if self.kind == "ident":
            return f'Identifier("{self.text}")'
        if self.kind == "reg":
            return f'Register("{self.text}")'
        if self.kind == "num":
            return {10: "Number", 16: "Hex", 2: "Binary"}[self.base] \
                + f"({self.value})"
        if self.kind == "directive":
            return f'Directive("{self.text}")'
        return {"comma": "Comma", "colon": "Colon", "lparen": "LParen",
                "rparen": "RParen"}[self.kind]


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t]+)
  | (?P<comment>\#[^\n]*)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<bin>0b[01]+)
  | (?P<num>-?[0-9]+)
  | (?P<word>[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<directive>\.[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<comma>,)
  | (?P<colon>:)
  | (?P<lparen>\()
  | (?P<rparen>\))
    """,
    re.VERBOSE,
)


class LexError(ValueError):
    pass


def tokenize(line: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    n = len(line)
    while pos < n:
        m = _TOKEN_RE.match(line, pos)
        if m is None:
            # Reference message text (parser.rs:78-81); the reference
            # wraps it in a line-0 SyntaxError — the assembler supplies
            # the real line number instead.
            raise LexError(f"Invalid token at position {pos}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "hex":
            tokens.append(Token("num", text, int(text, 16), base=16))
        elif kind == "bin":
            tokens.append(Token("num", text, int(text, 2), base=2))
        elif kind == "num":
            tokens.append(Token("num", text, int(text)))
        elif kind == "word":
            lowered = text.lower()
            if lowered in REG_ALIASES:
                tokens.append(Token("reg", text))
            else:
                tokens.append(Token("ident", text))
        elif kind == "directive":
            tokens.append(Token("directive", text[1:]))
        else:
            tokens.append(Token(kind, text))
    return tokens
