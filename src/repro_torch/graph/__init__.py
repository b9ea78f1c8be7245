"""Host graphs, generators, partitioners and the partitioned graph."""
