"""Launch entry points of the port: the dry run and deploy-time tuner,
meshes, the multi-process pod and LM serving."""
