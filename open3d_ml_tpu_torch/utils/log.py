"""Logging helpers: a {}-style ``LogRecord``, the run-id allocator of the
summary directories, and code as a markdown block.

Counterpart of ``open3d_ml_tpu/utils/log.py``.
"""

import logging
from os import listdir
from os.path import exists


class LogRecord(logging.LogRecord):
    """A ``LogRecord`` that formats its message with ``str.format``
    ({}-style)."""

    def getMessage(self):
        msg = self.msg
        if self.args:
            if isinstance(self.args, dict):
                msg = msg.format(**self.args)
            else:
                msg = msg.format(*self.args)
        return msg


def get_runid(path):
    """The next 5-digit run id for the directory ``path``: one more than
    the largest NNNNN among its siblings named ``<NNNNN>_<name of path>``,
    "00001" where there is none."""
    name = path.split("/")[-1]
    parent = path[:-len(name)] or "."
    if not exists(parent):
        return "00001"
    runid = 0
    for entry in listdir(parent):
        try:
            number, rest = entry.split("_", 1)
        except ValueError:
            continue
        if rest == name and number.isdigit():
            runid = max(runid, int(number))
    return str(runid + 1).zfill(5)


def code2md(code_text, language="python"):
    """``code_text`` as a markdown code block (for TensorBoard's text
    plugin)."""
    return f"```{language}\n{code_text}\n```"
