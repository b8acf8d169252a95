"""The plain reference of the benchmark: exact Personalized PageRank in
float64 from the edge list the benchmark made (``ppr``), and frozen
copies of the program's query draw and precision@k (``queries``,
``metrics``).  It imports nothing of the program and takes nothing the
program made."""
