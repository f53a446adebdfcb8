"""The workflow commands of ``python -m circuitmap_torch`` (port of
``scripts_tpu/``), one module per JAX script, with the same file name,
flags, output files and printed lines. Each has ``main(argv=None)``,
which ``circuitmap_torch.__main__`` calls in process.

Every command runs on the GPU by default; ``--device cpu`` runs it on
the CPU (the package's device rule: without a GPU and without that
request, the command raises).
"""


def add_device_argument(parser):
    """The ``--device`` flag every command takes."""
    parser.add_argument("--device", default=None,
                        help="torch device of the demix and the fits "
                             "(default cuda; 'cpu' runs without a GPU)")
