"""Entry points: serving (``serve``, ``bench_serve``) and training
(``train``)."""
