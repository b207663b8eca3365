"""The port's deployment: the one-command process cluster
(``run_local``), its e2e loop (``e2e_loop``), the docker-compose file and
the image, the Kubernetes manifests and their offline validator
(``k8s_validate``), and the service configs under ``config/``.  See
``README.md`` beside this file."""
