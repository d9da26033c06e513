"""The plain reference: the same mathematics as the port, written again in
plain PyTorch from the definitions, with no code, table or state of the
port (``tomobar_tpu_torch`` is never imported here).  Every function takes
``prec``: "fp32" computes as the configuration states, "bf16" rounds every
stage's result to bfloat16 (the control: the next precision below)."""
