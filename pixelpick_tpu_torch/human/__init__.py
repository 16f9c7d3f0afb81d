"""The human annotation tools: the keyboard annotator
(``annotation.py``) and the VIA browser bridge (``via.py``)."""
