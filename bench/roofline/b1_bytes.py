"""B1, the quantize-with-error-feedback of the packed gradient: the bytes
the operation needs, whatever implements it. For n gradient elements in
rows of 1024:
  the gradient, read once in the parameters' dtype     2 B (bfloat16)
  the residual, read and written once in float32        8 B
  the int8 codes, written once                          1 B
  one float32 scale a row, written once                 4 B a row
= 11 B an element plus 4 B a row. The uniform draws are not counted, so
that a kernel that makes them itself, or fuses the packing, never reads
above 1."""

BYTES_PER_ELEMENT = 11
BYTES_PER_ROW = 4
ROW = 1024


def bytes_needed(n_elements: int) -> int:
    rows = -(-n_elements // ROW)
    return BYTES_PER_ELEMENT * n_elements + BYTES_PER_ROW * rows


def least_seconds(n_elements: int, peaks: dict) -> float:
    return bytes_needed(n_elements) / peaks["hbm_bytes_s"]
