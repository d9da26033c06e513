"""Every test here builds its tiny copy with ``tiny_cells.tiny_root``,
which cuts the cells that ``tiny.py`` predates to the tiny size as well."""

from benchmark.tests import tiny, tiny_cells

tiny.tiny_root = tiny_cells.tiny_root
