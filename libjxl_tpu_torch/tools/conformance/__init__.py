"""Conformance checker (``conformance``), corpus runner
(``run_corpus``) and corpus generator (``generate_corpus``); ports of
tools/conformance/."""
