# Copied verbatim from shud_tpu/utils/errors.py; only the package imports differ.
"""Typed failure codes — the reference's fail-fast ``myexit`` contract
(functions.cpp:10-35; codes Macros.hpp:227-233).  Raised as exceptions so
callers (CLI, autocalibration loops) can catch; the CLI converts to the
matching process exit code."""

from __future__ import annotations

ERR_NAN = 10
ERR_FILEIO = 12
ERR_DATAIN = 13
ERR_SOLVER = 19
ERR_CONSISTENCY = 20


class ShudError(RuntimeError):
    code = ERR_CONSISTENCY


class NanError(ShudError):
    code = ERR_NAN


class SolverError(ShudError):
    code = ERR_SOLVER


class DataError(ShudError):
    code = ERR_DATAIN
