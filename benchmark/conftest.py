"""Makes ``benchmark/tests/tiny_mesh.py``'s ``tiny_root`` the one that
``benchmark/tests/conftest.py`` hands every test there (it takes
``tiny_cells.tiny_root``, which this replaces before it is read), so the
tests' tiny copy cuts ``fista_pdtv.mesh4`` to the tiny size as well."""

from benchmark.tests import tiny_cells, tiny_mesh

tiny_cells.tiny_root = tiny_mesh.tiny_root
