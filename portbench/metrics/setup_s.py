"""Seconds from the process's start to the first measured job (host clock):
imports, the device-side generator, the program's host graph build and one
warm-up job cut to the traffic's ``warmup_ticks``."""


def read(run):
    return run.setup_s
