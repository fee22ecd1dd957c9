"""Distributed helpers of the port. So far only the int8 quantizer of
``compression.py``, which the serving precision path shares."""
