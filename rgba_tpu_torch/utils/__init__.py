"""Measurement helpers: CUDA-event timing (``benchmark.device_time``) and
the card's health canary (``health.chip_health``)."""
