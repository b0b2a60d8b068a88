"""Compute-ACAM numerics: formats, the table compiler, the operator library."""
