"""Analytic accounting helpers (`flops`)."""
