"""Execution runtime: the RenderPlan executor."""
