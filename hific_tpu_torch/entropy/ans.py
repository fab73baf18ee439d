"""64-bit vectorized rANS core (host-side, numpy).

This package's own copy of the JAX package's `entropy/ans.py`; the bytes it
writes are held equal to that coder's by tests/test_torch_entropy.py.

Streaming rANS (Duda, arXiv:1402.3392) with a lane-parallel 64-bit state:
each lane holds a uint64 head; 32-bit renormalization spills/refills against
a shared uint32 stack. Flattening emits [head >> 32, head & 0xffffffff] per
lane followed by the stack chunks newest-first, all as uint32.
"""

from typing import Tuple

import numpy as np

RANS_L = np.uint64(1 << 31)  # lower bound of the normalization interval
_U32_MASK = np.uint64(0xFFFFFFFF)


class Message:
    """rANS message: per-lane uint64 heads + a uint32 spill stack.

    During encoding the stack is a list of arrays (append = push).
    During decoding the stack is one flat array consumed front-to-back.
    """

    __slots__ = ("head", "stack", "cursor")

    def __init__(self, head: np.ndarray, stack=None, cursor: int = 0):
        self.head = head
        self.stack = [] if stack is None else stack
        self.cursor = cursor

    # -- encode-side stack ops
    def spill(self, words: np.ndarray):
        self.stack.append(words)

    # -- decode-side stack ops
    def refill(self, n: int) -> np.ndarray:
        out = self.stack[self.cursor : self.cursor + int(n)]
        self.cursor += int(n)
        return out


def empty_message(shape) -> Message:
    return Message(np.full(shape, RANS_L, dtype=np.uint64))


def rans_push(msg: Message, starts, freqs, precision) -> None:
    """Encode one symbol per lane, in place.

    starts/freqs: uint64 arrays broadcastable to msg.head.shape; the symbol's
    interval [start, start+freq) under a CDF quantized to 2**precision.
    """
    head = np.asarray(msg.head)
    starts = np.asarray(starts, dtype=np.uint64)
    freqs = np.asarray(freqs, dtype=np.uint64)
    # Renormalize: spill low 32 bits of lanes that would overflow.
    x_max = ((RANS_L >> np.uint64(precision)) << np.uint64(32)) * freqs
    over = np.asarray(head >= x_max)
    if np.any(over):
        msg.spill(np.ravel(head[over]).astype(np.uint32))
        head = head.copy()
        head[over] >>= np.uint64(32)
    div, mod = np.divmod(head, freqs)
    msg.head = np.asarray((div << np.uint64(precision)) + mod + starts)


def rans_pop(msg: Message, precision) -> Tuple[np.ndarray, "callable"]:
    """Returns (interval_starts, complete_fn). The caller maps the interval
    start (cumulative frequency) to a symbol via its decoder table, then
    calls complete_fn(starts, freqs) to advance the state."""
    head = np.asarray(msg.head)
    interval_starts = np.asarray(head & np.uint64((1 << precision) - 1))

    def complete(starts, freqs):
        starts = np.asarray(starts, dtype=np.uint64)
        freqs = np.asarray(freqs, dtype=np.uint64)
        new_head = np.asarray(
            freqs * (head >> np.uint64(precision)) + interval_starts - starts)
        under = np.asarray(new_head < RANS_L)
        n = int(np.sum(under))
        if n > 0:
            refill_words = msg.refill(n).astype(np.uint64)
            if new_head.ndim == 0:
                new_head = np.asarray(
                    (new_head << np.uint64(32)) | refill_words[0])
            else:
                new_head = new_head.copy()
                new_head[under] = (new_head[under] << np.uint64(32)) | refill_words
        msg.head = new_head
        return msg

    return interval_starts, complete


def flatten_message(msg: Message) -> np.ndarray:
    """Serialize to a flat uint32 array (stack chunks newest-first, matching
    the reference layout)."""
    head = np.ravel(msg.head)
    parts = [(head >> np.uint64(32)).astype(np.uint32), head.astype(np.uint32)]
    parts.extend(reversed(msg.stack))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint32)


def unflatten_message(arr: np.ndarray, shape) -> Message:
    """Deserialize a flat uint32 array into a vector message of lane shape
    `shape`."""
    size = int(np.prod(shape))
    arr = np.asarray(arr, dtype=np.uint32)
    head = (arr[:size].astype(np.uint64) << np.uint64(32)) | arr[
        size : 2 * size
    ].astype(np.uint64)
    return Message(head.reshape(shape), stack=arr[2 * size :], cursor=0)



def unflatten_message_scalar(arr: np.ndarray) -> Message:
    """Deserialize a flat uint32 array into a one-lane (scalar) message."""
    arr = np.asarray(arr, dtype=np.uint32)
    if arr.size < 2:
        raise ValueError("corrupt scalar stream: fewer than two head words")
    head = (np.uint64(arr[0]) << np.uint64(32)) | np.uint64(arr[1])
    return Message(np.array(head, dtype=np.uint64), stack=arr[2:], cursor=0)
