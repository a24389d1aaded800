"""The system under test of a one-card cell, built by the module its
configuration names under ``codec`` (``benchmark/codecs/<codec>.py``,
``torch_codec`` where the key is absent). A module's ``build(config,
device)`` returns the server: an object with the methods the mix's
request kinds call (``encode``, ``decode``, ``decode_range``). A new
system under test is a new module and its name in a configuration."""

from __future__ import annotations

import importlib


def build(config: dict, device):
    name = config.get("codec", "torch_codec")
    return importlib.import_module(f"benchmark.codecs.{name}").build(
        config, device)
