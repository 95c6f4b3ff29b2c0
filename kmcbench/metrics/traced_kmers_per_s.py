"""traced_kmers_per_s: kmers_per_s (its reader) read in a traced run, in
the cells whose untraced rate spreads from run to run too widely for a
bound: the host's slow spells move it by 10-20% (PERF.md, sections 2
and 6).  The probes and the profiler's first jobs are inside its window,
so it reads below the untraced rate of the same cell."""
from kmcbench.harness import load_reader

read = load_reader("kmers_per_s").read
