"""Shared hardening for the from-scratch image codecs.

Every public decode function parses untrusted bytes (clinical exports get
truncated and bit-rotted in transit). The parsers raise ValueError with a
precise message for the corruptions they detect explicitly; for the long
tail — a slice that comes back short, a table id that was never defined, a
zero dimension used as a divisor — the public contract is still "raise
ValueError", not whatever internal exception the parse happened to hit
(tests/test_codec_fuzz.py drives this with truncation/bit-flip/garbage
mutations). Encoders are NOT wrapped: they consume trusted arrays, and an
internal error there is a real bug that should surface as-is.

The port's own copy of the JAX package's data/codec_util.py, its code unchanged,
so that the port imports nothing of that package.
"""

from __future__ import annotations

import functools
import struct


def corrupt_stream_guard(fn):
    """Map internal parse failures on malformed input to ValueError."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except ValueError:
            raise
        except (IndexError, KeyError, struct.error, OverflowError,
                ZeroDivisionError) as e:
            raise ValueError(
                f"corrupt or truncated stream ({type(e).__name__}: {e})"
            ) from e

    return wrapper
