"""Parallelism: an in-process data mesh and the (``space``, ``data``)
process mesh (``mesh``), the process group of a job (``distributed``), the
rank launcher (``launch``), height sharding's exchanges and scope
(``spatial``) and the multi-rank dry run (``dryrun``)."""
