"""Samplers, timing, profiling, the issue-rate probes and the roofline."""
