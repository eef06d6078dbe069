"""Prefill compression policies and decode-phase schedulers."""
