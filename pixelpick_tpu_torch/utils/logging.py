"""CSV logging, byte-compatible with the reference's ``write_log``
(``utils/utils.py:66-72``); an own copy of ``pixelpick_tpu/utils/logging.py``
``write_log``: ``header`` truncates and writes the header line,
``list_entities`` appends one CSV row."""

from __future__ import annotations


def write_log(fp: str, list_entities=None, header=None) -> None:
    mode = "w" if header is not None else "a"
    with open(fp, mode) as f:
        if header is not None:
            f.write(",".join(str(h) for h in header) + "\n")
        if list_entities is not None:
            f.write(",".join(str(e) for e in list_entities) + "\n")
