"""Data parallelism: an in-process data mesh (``mesh``), the process group
of a job (``distributed``) and the data-parallel dry run (``dryrun``)."""
