"""The general parts of the benchmark: finding a cell's files by name
(``spec``), one run of a cell (``cell``), the profiler's ranges and trace
(``trace``) and the command line (``main``)."""
