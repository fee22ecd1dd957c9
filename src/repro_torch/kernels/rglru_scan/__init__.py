"""rglru_scan: the RG-LRU's diagonal linear recurrence
(``csrc/rglru_scan.cu``)."""
