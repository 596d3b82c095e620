"""skode — the streaming character-level command parser.

A semantic re-implementation of the reference parser (reference: skode.c,
skode.h).  The wire language is a stream of:

  * numbers            — pushed onto an 8-slot argument stack
  * atoms (≤ 4 chars)  — command names; an atom is *dispatched lazily*, when
                         the next atom begins or at chunk end, so the numbers
                         following it are its arguments
  * ``{strings}``      — stashed verbatim (used by the sequencer ``x`` step set)
  * ``(arrays)``       — numeric literals incl. hex, for sample-data upload
  * ``$0``-``$9``      — variables, pushed as arguments
  * ``#`` comments     — to end of line (or ``;``)
  * ``;`` / EOT        — chunk end
  * ``+N`` / ``~N``    — defer prefix (beats / seconds); the rest of the text
                         up to the next ``+``/``~``/``;``/EOL is the deferred
                         program
  * ``[`` / ``]``      — voice-stack push/pop

Parser state persists across ``feed()`` calls, so strings/arrays may span
lines (reference: skode.c:283 keeps state in skode_t across calls).

Faithful quirks preserved:
  * an atom is dispatched only when the *next* atom completes or at chunk
    end (reference: skode.c:258-267);
  * ``skode_strtod`` returns NaN for the single characters ``-``, ``e``,
    ``.`` (reference: skode.c:26-31), otherwise C ``strtod`` semantics
    (longest valid prefix, 0.0 on no-parse, hex accepted);
  * atoms longer than 4 characters are silently truncated to 4
    (reference: skode.c:198-203);
  * the ``+`` form of defer multiplies by ``tempo_time_per_step*4`` at
    *dispatch* time in the wire layer, not here.
"""

from __future__ import annotations

import math
import re
from typing import Callable, List

# callback info codes (reference: skode.h:4-25)
FUNCTION = 12
DEFER = 13
GOT_STRING = 14
GOT_ARRAY = 15
PUSH = 16
POP = 17
CHUNK_END = 9

# internal states (reference: skode.h:4-14)
_START = 0
_GET_NUMBER = 1
_GET_VARIABLE = 2
_GET_DEFER_NUMBER = 3
_GET_DEFER_STRING = 4
_GET_ATOM = 5
_GET_STRING = 6
_GET_ARRAY = 7
_GET_COMMENT = 8

ARG_MAX = 8          # reference: skode.c:33
ATOM_MAX = 4         # reference: skode.c:35
VAR_MAX = 10         # reference: skode.c:37
ATOM_NIL = None

_ATOM_EXTRA = set("!@%^&*_=:\"'<>?/")

# C strtod: optional sign, then hex (0x...) or decimal with optional exponent.
_DEC_RE = re.compile(r"[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?")
_HEX_RE = re.compile(
    r"[+-]?0[xX](?:[0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?"
)


def c_strtod(s: str) -> float:
    """C ``strtod``: parse the longest valid numeric prefix; 0.0 if none."""
    m = _HEX_RE.match(s)
    if m:
        txt = m.group(0)
        # float.fromhex needs an explicit exponent? It accepts "0x1A" fine.
        try:
            return float.fromhex(txt)
        except ValueError:
            pass
    m = _DEC_RE.match(s)
    if m:
        return float(m.group(0))
    return 0.0


def skode_strtod(s: str) -> float:
    """Reference skode.c:26-31 — lone '-', 'e', '.' parse as NaN."""
    if len(s) == 1 and s in "-e.":
        return math.nan
    return c_strtod(s)


_ASCII_DIGITS = set("0123456789")
_ASCII_ALPHA = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
_C_SPACE = set(" \t\n\v\f\r")


def _is_number(c: str) -> bool:
    return c in _ASCII_DIGITS or c in "-."


def _is_separator(c: str) -> bool:
    return c in _C_SPACE or c == ","


def _is_chunk_end(c: str) -> bool:
    return c == ";" or c == "\x04"


def _is_defer(c: str) -> bool:
    return c in "+~"


def _is_atom(c: str) -> bool:
    # C isalpha() in the C locale: ASCII letters only (skode.c:22)
    return c in _ASCII_ALPHA or c in _ATOM_EXTRA


def _is_number_ex(c: str) -> bool:
    # array literals allow hex constants (reference: skode.c:24)
    return c in "0123456789abcdefABCDEF-.eExX"


class Skode:
    """Streaming parser instance (reference skode_t, skode.c:39-80).

    ``fn(parser, info)`` is invoked with one of FUNCTION / DEFER /
    CHUNK_END / GOT_STRING / GOT_ARRAY / PUSH / POP.  For FUNCTION the
    current atom is in ``self.atom`` (a string of exactly 4 chars, padded
    with '_') and arguments in ``self.arg[:self.arg_len]``.
    """

    def __init__(self, fn: Callable[["Skode", int], int], user=None):
        self.fn = fn
        self.user = user
        # scratch string {…}
        self.scr: List[str] = []
        # number accumulator
        self.num: List[str] = []
        # data array (…)
        self.data: List[float] = []
        # defer
        self.defer_acc: List[str] = []
        self.defer_num = 0.0
        self.defer_mode = "?"
        # args
        self.arg: List[float] = [0.0] * ARG_MAX
        self.arg_len = 0
        # atom
        self.atom_acc: List[str] = []
        self.atom: str | None = ATOM_NIL   # packed (4-char padded) atom
        # vars: local per parser; global shared (reference skode.c:70-72)
        self.local_var: List[float] = [0.0] * VAR_MAX
        self.global_var: List[float] = self.local_var
        self.global_save: List[float] = self.local_var
        self.state = _START
        self.mode = 0      # 0 = flush chunk at end of each feed()
        self.trace = 0

    # ---- small helpers mirroring the C accessors ----
    def set_global(self, g: List[float]) -> None:
        self.global_var = g
        self.global_save = g

    def use_local(self) -> None:
        self.global_var = self.local_var

    def use_global(self) -> None:
        self.global_var = self.global_save

    def set_local(self, n: int, x: float) -> None:
        # reference skode.c:482 — writes through the *current* pointer
        self.global_var[n] = x

    def local_to_global(self, n: int) -> None:
        if 0 <= n <= 9:
            self.global_var[n] = self.local_var[n]

    def global_to_local(self, n: int) -> None:
        if 0 <= n <= 9:
            self.local_var[n] = self.global_var[n]

    @property
    def string(self) -> str:
        return "".join(self.scr)

    @property
    def defer_string(self) -> str:
        return "".join(self.defer_acc)

    def args(self) -> List[float]:
        return self.arg[: self.arg_len]

    def arg_clear(self) -> None:
        self.arg_len = 0

    def arg_push(self, d: float) -> None:
        if self.arg_len < ARG_MAX:
            self.arg[self.arg_len] = d
            self.arg_len += 1

    def arg_drop(self) -> float:
        if self.arg_len > 0:
            x = self.arg[0]
            self.arg[:-1] = self.arg[1:]
            self.arg_len -= 1
            return x
        return 0.0

    def arg_swap(self) -> float:
        if self.arg_len > 1:
            self.arg[0], self.arg[1] = self.arg[1], self.arg[0]
        return 0.0

    # ---- internals ----
    def _num_get(self) -> float:
        return skode_strtod("".join(self.num))

    def _atom_finish(self) -> None:
        # pack ≤4 chars, pad with '_' (reference skode.c:213-218 packs into
        # an int over 0x5f5f5f5f = "____"; we keep the equivalent string)
        a = "".join(self.atom_acc[:ATOM_MAX])
        self.atom = (a + "____")[:4]

    def _array_push(self) -> None:
        if self.num:
            self.data.append(self._num_get())
        self.num = []

    def _action(self, state: int) -> int:
        # reference skode.c:231-281
        if state == CHUNK_END:
            pushes = 0
            if self.atom is not ATOM_NIL:
                pushes = self.fn(self, FUNCTION)
                self.atom = ATOM_NIL
            if self.defer_acc:
                self.fn(self, DEFER)
                self.defer_acc = []
            self.fn(self, CHUNK_END)
            if pushes == 0:
                self.arg_clear()
            return 0
        if state == _GET_ATOM:
            if self.atom is not ATOM_NIL:
                if self.fn(self, FUNCTION) == 0:
                    self.arg_clear()
                self.atom = ATOM_NIL
            self._atom_finish()
            self.atom_acc = []
        elif state == _GET_NUMBER:
            self.arg_push(self._num_get())
            self.num = []
        elif state == _GET_DEFER_STRING:
            self.fn(self, DEFER)
            self.defer_acc = []
        return _START

    def feed(self, line: str) -> int:
        """Process one chunk of input (reference skode.c:283-429)."""
        i = 0
        n = len(line)
        while True:
            if i >= n:
                if self.state in (_GET_ATOM, _GET_NUMBER):
                    self._action(self.state)
                    self.state = _START
                break
            c = line[i]
            reprocess = True
            while reprocess:
                reprocess = False
                st = self.state
                if st == _START:
                    if _is_number(c):
                        self.num = [c]
                        self.state = _GET_NUMBER
                    elif _is_separator(c):
                        pass
                    elif c == "[":
                        self.fn(self, PUSH)
                    elif c == "]":
                        self.fn(self, POP)
                    elif c == "{":
                        self.scr = []
                        self.state = _GET_STRING
                    elif c == "(":
                        self.num = []
                        self.data = []
                        self.state = _GET_ARRAY
                    elif c == "$":
                        self.state = _GET_VARIABLE
                    elif c == "#":
                        self.state = _GET_COMMENT
                    elif _is_chunk_end(c):
                        self._action(CHUNK_END)
                        self.state = _START
                    elif _is_defer(c):
                        self._action(CHUNK_END)
                        self.defer_mode = c
                        self.state = _GET_DEFER_NUMBER
                    elif c < " " or c == "\x7f":   # iscntrl
                        pass
                    else:
                        self.atom_acc = [c]
                        self.state = _GET_ATOM
                elif st == _GET_NUMBER:
                    if _is_number(c):
                        self.num.append(c)
                    elif c == "$":
                        pass  # reference prints "VAR?" and ignores
                    else:
                        self.state = self._action(st)
                        reprocess = True
                elif st == _GET_STRING:
                    if c == "}":
                        self.fn(self, GOT_STRING)
                        self.state = _START
                    else:
                        self.scr.append(c)
                elif st == _GET_ARRAY:
                    if c == ")":
                        self._array_push()
                        self.fn(self, GOT_ARRAY)
                        self.state = _START
                    elif _is_number_ex(c):
                        self.num.append(c)
                    elif _is_separator(c):
                        self._array_push()
                    else:
                        pass  # ignore unknown chars in arrays
                elif st == _GET_COMMENT:
                    if _is_chunk_end(c):
                        self._action(CHUNK_END)
                        self.state = _START
                    elif c == "\n":
                        self._action(st)
                        self.state = _START
                elif st == _GET_VARIABLE:
                    if c in _ASCII_DIGITS:
                        self.arg_push(self.global_var[ord(c) - 48])
                        self.state = _START
                    else:
                        self.state = _START
                        reprocess = True
                elif st == _GET_DEFER_NUMBER:
                    if _is_number(c):
                        self.num.append(c)
                    else:
                        self.defer_num = self._num_get()
                        self.num = []
                        self.state = _GET_DEFER_STRING
                        reprocess = True
                elif st == _GET_DEFER_STRING:
                    if _is_defer(c):
                        # reference skode.c:399-401 sets defer_mode *before*
                        # firing the pending DEFER — a chained defer is
                        # dispatched with the NEXT prefix's mode (quirk kept)
                        self.defer_mode = c
                        self._action(_GET_DEFER_STRING)
                        self.state = _GET_DEFER_NUMBER
                    elif _is_chunk_end(c):
                        self._action(_GET_DEFER_STRING)
                        self.state = _START
                    else:
                        self.defer_acc.append(c)
                elif st == _GET_ATOM:
                    if _is_atom(c):
                        if len(self.atom_acc) < ATOM_MAX:
                            self.atom_acc.append(c)
                    else:
                        self._action(st)
                        self.state = _START
                        reprocess = True
                else:
                    self._action(st)
                    self.state = _START
            i += 1
        if self.mode == 0:
            self._action(CHUNK_END)
            self.state = _START
        return 0
