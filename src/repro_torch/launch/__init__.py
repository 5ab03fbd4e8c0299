"""Launch-time analysis of distributed programs — counterpart of
``repro/launch``: the shard meshes (``mesh.py``), the SQL fragments of the
paper's scale-out workload (``sql_dryrun.py``), what a fragment moves and
holds (``analysis.py``), seeded data for running them and the plain answers
they are held to (``sql_data.py``), and the dry run's command line (``dryrun.py``).
"""
