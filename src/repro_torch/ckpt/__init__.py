"""Checkpoints in ``repro``'s container format and the packed-int4 TT
deploy export (``export_tt_deploy`` / ``load_tt_deploy``)."""
from .checkpoint import (export_tt_deploy, load, load_tt_deploy,  # noqa: F401
                         save)
