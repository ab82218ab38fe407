"""Checkpoints in ``repro``'s container format — synchronous
``save``/``load``, the asynchronous ``AsyncCheckpointer`` with its step
files (``step_path``, ``latest_step``), the SIGTERM hook
``install_preemption_handler`` — and the packed-int4 TT deploy export
(``export_tt_deploy`` / ``load_tt_deploy``)."""
from .checkpoint import (AsyncCheckpointer, Stacked,  # noqa: F401
                         export_tt_deploy, install_preemption_handler,
                         latest_step, load, load_tt_deploy, save, step_path)
