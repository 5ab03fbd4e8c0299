"""Launch-time analysis of distributed programs — counterpart of
``repro/launch``: the shard meshes (``mesh.py``), the SQL fragments of the
paper's scale-out workload (``sql_dryrun.py``), what a program moves and
holds (``analysis.py``), seeded data for running the fragments and the
plain answers they are held to (``sql_data.py``), the production sharding
rules as shard layouts (``sharding.py``), one shard's program of each model
cell (``model_dryrun.py``), and the dry run's command line (``dryrun.py``).
"""
