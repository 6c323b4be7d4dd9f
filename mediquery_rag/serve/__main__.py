from mediquery_rag.serve.server import main

main()
