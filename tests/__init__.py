"""Test suite (a package, so ``tests.*`` helpers import ahead of any
other top-level ``tests`` package on the path)."""
