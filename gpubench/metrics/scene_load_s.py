"""Seconds of the scene load in set-up (host clock, ended by a synchronise):
the scene text and OBJ parse, the KD and cluster builds, the move to the
device."""


def read(run):
    return run.scene_load_s
