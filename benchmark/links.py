"""The published link rate of one H100 SXM, frozen here so that a later
change to the program cannot move the yardstick (as ``work.py`` freezes
the card's peaks).

``H100_SXM_NVLINK_BYTES``: NVLink 4 on an H100 SXM, 18 links of 25 GB/s
of payload in each direction, 450 GB/s into a card (NVIDIA's H100 data
sheet: 900 GB/s both directions together).  ``nvidia-smi nvlink -s``
reads 26.562 GB/s a link on an H100 80GB HBM3: the signalling rate, of
which the packets' headers leave the 25 GB/s of payload.  No topology of
four cards gives a card more than its 18 links, so the bytes received
over that rate bound the time a halo exchange can take from below: a
share above 100% is a counting fault and is reported as it is, never
clamped."""

H100_SXM_NVLINK_BYTES = 450e9
